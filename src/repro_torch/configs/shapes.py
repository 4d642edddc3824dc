"""Assigned input shapes (the torch twin of ``repro/configs/shapes.py``):
every arch runs all four unless its family makes a shape inapplicable
(recorded per arch in SKIP_SHAPES)."""
from repro_torch.models.api import ShapeSpec

SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

FULL_ATTENTION_SKIP = (
    "long_500k requires sub-quadratic attention; this arch is pure "
    "full-attention (see DESIGN.md §Arch-applicability)"
)
