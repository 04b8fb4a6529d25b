// The flash forward body's (flash_fwd.cuh) wide tier: head widths above
// 64 up to 128 (a multiple of 8: 72, ViT-H's 80, 128) on two 64-column
// atoms, zero-filled past D: the forms of #1, #10, #11 and #14, compiled
// apart from their entry points (flash_attention.cu, fused_attention.cu)
// so that the build runs the tiers in parallel.
#include "flash_fwd.cuh"

namespace vt {
namespace flash {
VT_FLASH_FWD_TIER(, 2, false)
}  // namespace flash
}  // namespace vt
