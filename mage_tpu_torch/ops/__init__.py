from mage_tpu_torch.ops.axial_attention import axial_block_fused, axial_slot_attention
from mage_tpu_torch.ops.cached_attention import (
    cached_slot_attention,
    cached_slot_attention_quant,
    quantize_kv_slot,
)
from mage_tpu_torch.ops.gn_conv import gn_affine_rows, gn_silu_conv3x3, gn_stats
from mage_tpu_torch.ops.vq import (
    codebook_lookup,
    nearest_codebook_indices,
    nearest_with_codes,
    vq_straight_through,
)
from mage_tpu_torch.ops.vq_tail import vq_decode_tail
