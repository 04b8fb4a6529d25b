// Error text for the codes the C entry points return.
#include <cuda_runtime.h>

extern "C" const char* vt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }
