// The flash backward body's (flash_bwd.cuh) wide tier: head widths above
// 64 up to 128 (a multiple of 8: 72, ViT-H's 80, 128), a block per (key
// block, 64-column atom): the forms of #1b (bf16 dk / dv) and #10b (f32),
// compiled apart from their entry points (flash_attention_bwd.cu) so that
// the build runs the tiers in parallel.
#include "flash_bwd.cuh"

namespace vt {
namespace flash {
VT_FLASH_BWD_TIER(, 2, false)
}  // namespace flash
}  // namespace vt
