"""Operations of the single-device inversion path."""

from .batched import batched_jordan_invert
from .block_inverse import (
    batched_block_inverse,
    gauss_jordan_inverse,
    probe_blocks,
)
from .fused_update import (
    fused_normalize_eliminate,
    fused_normalize_eliminate_plain,
)
from .generators import GENERATORS, generate, generate_batch
from .gj_fused_panel import gj_fused_panel_plain
from .jordan import block_jordan_invert
from .jordan_inplace import (
    apply_col_perm,
    block_jordan_invert_inplace,
    block_jordan_invert_inplace_grouped,
    block_jordan_invert_inplace_grouped_lookahead,
    block_jordan_invert_inplace_grouped_pallas,
    block_jordan_invert_inplace_lookahead,
    compose_swap_perm,
)
from .norms import block_inf_norms, condition_inf, inf_norm
from .padding import pad_with_identity, unpad
from .probe_variants import (
    gj_inplace_plain,
    gj_panel_plain,
    gj_probe_inplace,
    gj_probe_panel,
    panel_width,
)
from .refine import newton_schulz, resolve_precision
from .residual import residual_inf_norm

__all__ = [
    "GENERATORS",
    "apply_col_perm",
    "batched_block_inverse",
    "batched_jordan_invert",
    "block_inf_norms",
    "block_jordan_invert",
    "block_jordan_invert_inplace",
    "block_jordan_invert_inplace_grouped",
    "block_jordan_invert_inplace_grouped_lookahead",
    "block_jordan_invert_inplace_grouped_pallas",
    "block_jordan_invert_inplace_lookahead",
    "compose_swap_perm",
    "condition_inf",
    "fused_normalize_eliminate",
    "fused_normalize_eliminate_plain",
    "gauss_jordan_inverse",
    "generate",
    "generate_batch",
    "gj_fused_panel_plain",
    "gj_inplace_plain",
    "gj_panel_plain",
    "gj_probe_inplace",
    "gj_probe_panel",
    "inf_norm",
    "newton_schulz",
    "pad_with_identity",
    "panel_width",
    "probe_blocks",
    "residual_inf_norm",
    "resolve_precision",
    "unpad",
]
