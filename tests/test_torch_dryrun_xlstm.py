"""The port's dry-run counter against the JAX package's ``HloCost`` for
xlstm-350m (mLSTM, sLSTM), on the CPU: the counter's FLOPs of a SMOKE
train, prefill and decode step on the CPU's plain path are within 1 % of
``HloCost`` for the JAX step after the closed-form structural differences
of ``torch_dryrun_common.py`` (the mLSTM's chunk products, the sLSTM's
first step), and the meta trace counts exactly what the CPU run counts. A
file of its own (and jamba's in ``test_torch_dryrun_jamba.py``): lowering
and compiling these families' JAX train steps takes half a minute each.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch_dryrun_common import KINDS, check_cell  # noqa: E402


@pytest.mark.parametrize("kind", KINDS)
def test_flops_against_hlocost_and_meta_equals_cpu(kind):
    check_cell("xlstm-350m", kind)
