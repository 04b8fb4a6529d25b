// The flash backward body's (flash_bwd.cuh) narrow tier: head widths below
// 64 (a multiple of 8; MiniLM's 32) on one 64-column atom, zero-filled past
// D: the forms of #1b (bf16 dk / dv) and #10b (f32), compiled apart from
// their entry points (flash_attention_bwd.cu) so that the build runs the
// tiers in parallel.
#include "flash_bwd.cuh"

namespace vt {
namespace flash {
VT_FLASH_BWD_TIER(, 1, false)
}  // namespace flash
}  // namespace vt
