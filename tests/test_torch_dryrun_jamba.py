"""The port's dry-run counter against the JAX package's ``HloCost`` for
jamba-1.5-large (Mamba, attention, MoE), on the CPU: the counter's FLOPs of
a SMOKE train, prefill and decode step on the CPU's plain path are within
1 % of ``HloCost`` for the JAX step after the closed-form structural
differences of ``torch_dryrun_common.py`` (the flash backward's recomputed
P V product, the Mamba readout's length-1 contraction), and the meta trace
counts exactly what the CPU run counts. A file of its own (and xLSTM's in
``test_torch_dryrun_xlstm.py``): lowering and compiling these families'
JAX train steps takes half a minute each.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_dryrun_common import KINDS, check_cell  # noqa: E402


@pytest.mark.parametrize("kind", KINDS)
def test_flops_against_hlocost_and_meta_equals_cpu(kind):
    check_cell("jamba-1.5-large-398b", kind)
