// The decode step's (#5, fused_decode_step.cuh) run-time forms of batch
// bound 2 (the fused decode's route, batch 1-2) and heads up to 64 wide
// (MiniLM's 32, BERT-large's 64): the four pairs of GEMV forms, compiled apart from
// the entry point (fused_decode_step.cu) so that the build compiles the
// forms in parallel.
#include "fused_decode_step.cuh"

namespace vt {
namespace step {
template cudaError_t launch_runtime<2, 2>(const Params&, int, cudaStream_t);
}  // namespace step
}  // namespace vt
