// The flash forward body's (flash_fwd.cuh) narrow tier: head widths below
// 64 (a multiple of 8; MiniLM's 32) on one 64-column atom, zero-filled past
// D: the forms of #1, #10, #11 and #14, compiled apart from their entry
// points (flash_attention.cu, fused_attention.cu) so that the build runs
// the tiers in parallel.
#include "flash_fwd.cuh"

namespace vt {
namespace flash {
VT_FLASH_FWD_TIER(, 1, false)
}  // namespace flash
}  // namespace vt
