"""The port's dry run against the JAX package's, on the CPU.

``configs/shapes`` and the registry's skips and cells equal JAX's; the meta
stand-ins (``input_specs``, ``param_shapes``, ``opt_state_shapes`` at f32,
bf16 and int8, ``quantized_shape_tree``) match JAX's ``ShapeDtypeStruct``
trees leaf for leaf at FULL size for all ten architectures;
``active_params`` and ``model_flops`` equal JAX's for all 40 cells to rel
1e-12. ``launch/cost.CostCounter``'s FLOPs of a SMOKE train, prefill and
decode step on the CPU's plain path are within 1 % of ``HloCost`` for the
JAX step (smollm-360m, glm4-9b, dbrx-132b, qwen2-vl-2b, whisper-large-v3
here; jamba and xLSTM in ``test_torch_dryrun_jamba.py`` and ``_xlstm.py``), after the
closed-form structural differences of ``torch_dryrun_common.py``, and the
meta trace counts exactly what the CPU run counts. The peak tracker
against a count by hand; each kernel wrapper's meta branch; the
``attn_scores_bf16`` knob; ``run_cell``'s records, the estimator and the
roofline twin reading them; the mesh and variants the port lacks raising,
and the ``moetok`` variants giving their base records.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.configs import shapes as j_shapes  # noqa: E402
from repro.launch import flops as j_flops  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models.quant import quantized_shape_tree as j_quantized_shape_tree  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro.train.optimizer import opt_state_shapes as j_opt_state_shapes  # noqa: E402
from repro_torch.benchmarks import roofline  # noqa: E402
from repro_torch.configs import registry, shapes  # noqa: E402
from repro_torch.core.estimator import LatencyEstimator  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.mlstm_chunk import ops as mk_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.launch import cost, dryrun  # noqa: E402
from repro_torch.launch import flops as t_flops  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.api import ShapeSpec  # noqa: E402
from repro_torch.models.bridge import params_from_jax  # noqa: E402
from repro_torch.models.quant import quantized_shape_tree  # noqa: E402
from repro_torch.train.optimizer import OptConfig, opt_state_shapes  # noqa: E402
from torch_dryrun_common import KINDS, check_cell  # noqa: E402

ARCHS = j_registry.list_archs()
FAMILIES = ("smollm-360m", "glm4-9b", "dbrx-132b", "qwen2-vl-2b", "whisper-large-v3")


# ---------------------------------------------------------------------------
# Shapes, skips, cells
# ---------------------------------------------------------------------------


def _spec(s):
    return (s.name, s.kind, s.seq_len, s.global_batch)


def test_shapes_skips_and_cells_equal_jax():
    assert {k: _spec(v) for k, v in shapes.SHAPES.items()} == {k: _spec(v) for k, v in j_shapes.SHAPES.items()}
    assert list(shapes.SHAPES) == list(j_shapes.SHAPES)
    assert shapes.FULL_ATTENTION_SKIP == j_shapes.FULL_ATTENTION_SKIP
    assert registry.list_archs() == ARCHS
    for arch in ARCHS:
        assert registry._MODULES[arch].SKIP_SHAPES == j_registry._MODULES[arch].SKIP_SHAPES, arch
        for name in shapes.SHAPES:
            assert registry.skip_reason(arch, name) == j_registry.skip_reason(arch, name)
    mine = [(a, _spec(s), r) for a, s, r in registry.cells()]
    theirs = [(a, _spec(s), r) for a, s, r in j_registry.cells()]
    assert mine == theirs and len(mine) == 40 and sum(bool(r) for _, _, r in mine) == 8


# ---------------------------------------------------------------------------
# Meta stand-ins leaf for leaf against JAX's ShapeDtypeStructs, FULL size
# ---------------------------------------------------------------------------


def _flat_torch(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_torch(v, f"{prefix}/{k}"))
        return out
    assert tree.device.type == "meta", prefix
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def _flat_jax(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"".join(f"/{getattr(k, 'key', k)}" for k in path): (tuple(x.shape), np.dtype(x.dtype).name)
            for path, x in flat}


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_trees_match_jax(arch):
    jm = j_get_model(j_registry.get_config(arch))
    tm = get_model(registry.get_config(arch))
    for spec in shapes.SHAPES.values():
        jspec = j_shapes.SHAPES[spec.name]
        assert _flat_torch(tm.input_specs(spec)) == _flat_jax(jm.input_specs(jspec)), (arch, spec.name)
    jp, tp = jm.param_shapes(), tm.param_shapes()
    assert _flat_torch(tp) == _flat_jax(jp)
    for sd in ("float32", "bfloat16", "int8"):
        got = opt_state_shapes(tp, OptConfig(state_dtype=sd))
        assert _flat_torch(got) == _flat_jax(j_opt_state_shapes(jp, JOptConfig(state_dtype=sd))), sd
    assert _flat_torch(quantized_shape_tree(tp)) == _flat_jax(j_quantized_shape_tree(jp))


# ---------------------------------------------------------------------------
# MODEL_FLOPS: all 40 cells
# ---------------------------------------------------------------------------


def test_model_flops_equal_jax_on_every_cell():
    n = 0
    for (arch, spec, _), (_, jspec, _) in zip(registry.cells(), j_registry.cells()):
        tm = get_model(registry.get_config(arch))
        jm = j_get_model(j_registry.get_config(arch))
        for a, b in zip(t_flops.active_params(tm), j_flops.active_params(jm)):
            assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0), arch
        a, b = t_flops.model_flops(tm, spec), j_flops.model_flops(jm, jspec)
        assert b > 0 and math.isclose(a, b, rel_tol=1e-12), (arch, spec.name, a, b)
        n += 1
    assert n == 40


# ---------------------------------------------------------------------------
# The counter's FLOPs against HloCost; meta == CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_flops_against_hlocost_and_meta_equals_cpu(arch, kind):
    check_cell(arch, kind)


# ---------------------------------------------------------------------------
# The counter by hand
# ---------------------------------------------------------------------------


def test_counter_by_hand():
    """FLOPs and bytes of a product and an add, views and allocations at 0,
    and the peak of the storages the program creates, autograd's saved
    activation included, each counted by hand."""
    x = torch.zeros(256)                      # an argument: not the step's
    a_ = torch.ones(4, 8)
    b_ = torch.ones(8, 3)
    with cost.CostCounter() as c:
        y = a_ @ b_                           # 2*4*3*8 FLOPs; 128 + 96 read, 48 written
        assert (c.flops, c.mem_bytes) == (192, 272)
        v = y.view(12)                        # a view: nothing
        e = torch.empty(5)                    # an allocation: no bytes, 20 live
        assert c.mem_bytes == 272
        del v, e
        a = x + 1                             # 1024 live (y's 48 too)
        b = a * 2                             # 2048
        del a                                 # 1024
        d = b.view(16, 16)                    # a view: no new storage
        e = torch.cat([b, b])                 # 1024 + 2048 = 3072 (+ y's 48): the peak
        del b, d                              # 2048
        f = e.sum()                           # + 4
    assert c.peak_bytes == 48 + 3072
    assert c.live_bytes == 48 + 2048 + 4
    del y, e, f
    w = torch.zeros(256, requires_grad=True)
    with cost.CostCounter() as c:
        s = torch.exp(w).sum()                # exp's output (1024) is saved for the backward
        assert c.live_bytes == 1024 + 4       # though no name holds it
        s.backward()                          # ones (4), the grad (1024); exp's output freed after
    assert c.peak_bytes == 1024 + 4 + 4 + 1024
    assert c.live_bytes == 4 + 1024           # s and w.grad


# ---------------------------------------------------------------------------
# The kernels' meta branches and their reported work
# ---------------------------------------------------------------------------


def _launch_counts():
    return [f.launches for f in (rms_ops.rmsnorm, fa_ops.flash_attention_bhsd, da_ops.decode_attention,
                                 mk_ops.mlstm_chunkwise_bh, pa_ops.paged_attention,
                                 pa_ops.paged_prefill_write, pa_ops.paged_prefill_write_quant)]


def test_kernel_wrappers_on_meta_launch_nothing_and_report_their_cost():
    m = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    before = _launch_counts()
    with cost.CostCounter() as c:
        out = rms_ops.rmsnorm(m(8, 960), m(960))
        assert out.shape == (8, 960) and out.is_meta
        assert (c.flops, c.mem_bytes) == (0, 2 * 8 * 960 * 2 + 960 * 2)
        o = fa_ops.flash_attention(m(2, 16, 6, 64), m(2, 16, 2, 64), m(2, 16, 2, 64))
        assert o.shape == (2, 16, 6, 64) and o.is_meta
        assert c.flops == 4 * 2 * 6 * 16 * 16 * 64
        f0 = c.flops
        o = da_ops.decode_attention(m(4, 1, 15, 64), m(4, 32, 5, 64), m(4, 32, 5, 64), 31)
        assert o.shape == (4, 1, 15, 64) and c.flops - f0 == 4 * 4 * 15 * 32 * 64
        h, C, n, mm = mk_ops.mlstm_chunkwise_bh(m(4, 16, 32), m(4, 16, 32), m(4, 16, 32),
                                                m(4, 16, dt=torch.float32), m(4, 16, dt=torch.float32),
                                                m(4, 32, 32, dt=torch.float32), m(4, 32, dt=torch.float32),
                                                m(4, dt=torch.float32), chunk=8)
        assert (h.shape, C.shape, n.shape, mm.shape) == ((4, 16, 32), (4, 32, 32), (4, 32), (4,))
        pool = m(9, 2, 16, 64)
        o = pa_ops.paged_attention(m(2, 1, 4, 64), pool, pool, torch.zeros(2, 3, dtype=torch.int32,
                                                                             device="meta"),
                                   torch.zeros(2, dtype=torch.int32, device="meta"))
        assert o.shape == (2, 1, 4, 64)
        row = torch.zeros(3, dtype=torch.int32, device="meta")
        assert pa_ops.paged_prefill_write(pool, pool, m(1, 40, 2, 64), m(1, 40, 2, 64), row)[0] is pool
        q8 = m(9, 2, 16, 64, dt=torch.int8)
        sc = m(9, 2, 16, 1)
        assert pa_ops.paged_prefill_write_quant(q8, q8, sc, sc, m(1, 40, 2, 64), m(1, 40, 2, 64), row)[0] is q8
    assert _launch_counts() == before
    # the CPU's plain versions report the same work as the meta branches
    qkv = [torch.zeros(s) for s in ((2, 16, 6, 64), (2, 16, 2, 64), (2, 16, 2, 64))]
    meta = [t.to("meta") for t in qkv]
    with cost.CostCounter() as c1:
        fa_ops.flash_attention(*qkv)
    with cost.CostCounter() as c2:
        fa_ops.flash_attention(*meta)
    assert (c1.flops, c1.mem_bytes) == (c2.flops, c2.mem_bytes)


def test_kernel_functions_on_meta_keep_the_plain_backward():
    """Under grad the meta forward goes through each Function, and its
    backward (the plain version's, recomputed) runs on the meta device."""
    q = torch.empty(2, 4, 16, 32, device="meta", requires_grad=True)
    kv = torch.empty(2, 2, 16, 32, device="meta", requires_grad=True)
    o = fa_ops.flash_attention_bhsd(q, kv, kv)
    assert o.grad_fn is not None
    (g,) = torch.autograd.grad(o.sum(), (q,))
    assert g.shape == q.shape and g.is_meta


# ---------------------------------------------------------------------------
# attn_scores_bf16
# ---------------------------------------------------------------------------


def _glm4_batch(cfg):
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    # positions given keep the plain attention, where the knob applies (the
    # flash kernel ignores it, as JAX's Pallas kernel does)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    return {"tokens": tokens, "labels": labels, "positions": pos}


def test_scores_bf16_close_to_f32():
    """The twin of ``tests/test_perf_variants.py::test_scores_bf16_close_to_f32``,
    then the port with the knob against JAX with the knob on JAX's tree."""
    cfg = registry.get_config("glm4-9b", smoke=True).replace(attn_chunk=8)
    jcfg = j_registry.get_config("glm4-9b", smoke=True).replace(attn_chunk=8)
    tree = jax.tree.map(np.asarray, j_get_model(jcfg).init(jax.random.PRNGKey(0)))
    params = params_from_jax(tree, cfg, "cpu")
    batch = _glm4_batch(cfg)
    l0, _ = get_model(cfg).loss(params, batch)
    l1, _ = get_model(cfg.replace(attn_scores_bf16=True)).loss(params, batch)
    assert abs(float(l0) - float(l1)) < 5e-2
    assert float(l0) != float(l1)                  # the knob reached the scores
    jl1, _ = j_get_model(jcfg.replace(attn_scores_bf16=True)).loss(
        None, jax.tree.map(jnp.asarray, tree), {k: jnp.asarray(v) for k, v in batch.items()})
    assert abs(float(l1) - float(jl1)) < 2e-2


# ---------------------------------------------------------------------------
# run_cell, the estimator and the roofline twin
# ---------------------------------------------------------------------------

RECORD_KEYS = {"arch", "shape", "mesh", "variant", "status", "trace_s", "params_bytes_per_dev", "mem",
               "cost", "roofline", "model_flops_global", "useful_compute_ratio"}


@pytest.fixture
def smoke_cells(monkeypatch):
    """``run_cell`` on SMOKE configs at small shapes (smollm-360m skips
    long_500k, as its FULL config does)."""
    get = registry.get_config
    monkeypatch.setattr(registry, "get_config", lambda arch, smoke=False: get(arch, smoke=True))
    small = {"train_4k": ShapeSpec("train_4k", "train", 16, 2),
             "prefill_32k": ShapeSpec("prefill_32k", "prefill", 16, 2),
             "decode_32k": ShapeSpec("decode_32k", "decode", 16, 2),
             "long_500k": ShapeSpec("long_500k", "decode", 32, 1)}
    monkeypatch.setattr(shapes, "SHAPES", small)


def test_run_cell_records_estimator_and_roofline(smoke_cells, tmp_path, capsys):
    assert dryrun.main(["--arch", "smollm-360m", "--outdir", str(tmp_path)]) == 0
    dryrun.main(["--arch", "dbrx-132b", "--shape", "train_4k", "--outdir", str(tmp_path)])
    dryrun.main(["--arch", "qwen1.5-32b", "--shape", "decode_32k", "--outdir", str(tmp_path)])
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert set(recs) == {f"single__smollm-360m__{s}.json" for s in shapes.SHAPES} | {
        "single__dbrx-132b__train_4k.json", "single__qwen1.5-32b__decode_32k.json"}
    skip = recs["single__smollm-360m__long_500k.json"]
    assert skip["status"] == "skip" and skip["reason"] == shapes.FULL_ATTENTION_SKIP
    assert recs["single__dbrx-132b__train_4k.json"]["opt_dtype"] == "float32"
    assert recs["single__qwen1.5-32b__decode_32k.json"]["kv_quant"] is True
    est = LatencyEstimator(str(tmp_path))
    for r in recs.values():
        if r["status"] != "ok":
            continue
        assert RECORD_KEYS <= set(r) and r["mesh"] == "1xH100"
        m = r["mem"]
        assert m["per_device_total"] == m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"] - m["alias_bytes"]
        assert r["cost"]["coll_wire_bytes_per_dev"] == 0.0 and r["cost"]["flops_per_dev"] > 0
        t = r["roofline"]
        assert set(t) == {"compute_s", "memory_s", "memory_hi_s", "collective_s", "bound", "step_s_lower_bound"}
        assert t["compute_s"] == r["cost"]["flops_per_dev"] / 989e12
        assert t["memory_s"] == r["cost"]["mem_lo_bytes_per_dev"] / 3.35e12
        assert est.step_time(r["arch"], r["shape"]) == max(t["compute_s"], t["memory_s"], t["collective_s"])
    dec = recs["single__smollm-360m__decode_32k.json"]["mem"]
    assert dec["alias_bytes"] > 0 and dec["alias_bytes"] < dec["argument_bytes"]   # the cache
    capsys.readouterr()
    roofline.main(["--dir", str(tmp_path)])
    rows = capsys.readouterr().out.splitlines()
    assert any(r.startswith("roofline.smollm-360m.train_4k,") for r in rows)
    assert any(r.startswith("roofline.smollm-360m.long_500k,0.000,SKIP:") for r in rows)
    assert rows[-1].startswith("roofline.summary,0.000,bounds=")


def test_the_mesh_and_knobs_the_port_lacks_raise(smoke_cells, tmp_path):
    with pytest.raises(NotImplementedError, match="item 10"):
        dryrun.main(["--mesh", "multi", "--outdir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="item 10"):
        dryrun.main(["--mesh", "both", "--outdir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="item 10"):
        dryrun.run_cell("smollm-360m", "train_4k", multi_pod=True)
    for variant in ("sp", "sbf16+sp"):
        with pytest.raises(NotImplementedError, match="seq_shard_activations"):
            dryrun.run_cell("dbrx-132b", "decode_32k", variant=variant)
    assert set(dryrun.VARIANTS) == {"w8", "moetok", "w8+moetok", "sbf16", "remat0", "sp", "sbf16+remat0",
                                    "sbf16+sp", "kvbf16", "unroll", "mb4", "mb4+sbf16"}
    w8 = dryrun.run_cell("smollm-360m", "decode_32k", variant="w8")
    assert w8["status"] == "ok" and w8["variant"] == "w8"


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_moetok_variants_keep_their_base_records(smoke_cells, shape):
    """``moetok`` and ``w8+moetok`` are JAX's lambdas; on the 1xH100 mesh no
    ctx reaches ``moe_ffn``, so their records are ``baseline``'s and
    ``w8``'s but for the variant (and the trace's wall time)."""
    def rec(variant):
        r = dryrun.run_cell("dbrx-132b", shape, variant=variant)
        assert r["status"] == "ok" and r["variant"] == variant
        return {k: v for k, v in r.items() if k not in ("variant", "trace_s")}

    assert dryrun.VARIANTS["moetok"](registry.get_config("dbrx-132b"), None).moe_token_gather
    assert rec("moetok") == rec("")
    assert rec("w8+moetok") == rec("w8")
