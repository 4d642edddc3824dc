"""The port's sharding rules against the JAX package's, in one process.

Every configuration's ``param_defs()`` tree (FULL and SMOKE, and the
Xception analog's) equals JAX's leaf for leaf in shape, logical axes, init
and scale; ``Rules.spec_for`` gives JAX's PartitionSpec for every leaf on
the meshes (16, 16), (2, 16, 16), (2, 4) and (8, 1) (JAX's on an
``AbstractMesh``), with ``fsdp_params`` off and on; ``MeshCtx``'s sizes and
batch specs equal JAX's. ``train/compression``'s
quantizer and ``ErrorFeedback`` are bit-exact against JAX's. The
collectives and the blocks a rank cuts are held to JAX's in
``test_torch_mesh.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import xception as j_xception  # noqa: E402
from repro.models.common import ParamDef as JParamDef  # noqa: E402
from repro.sharding import axes as j_axes  # noqa: E402
from repro.train import compression as j_comp  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import get_model, xception  # noqa: E402
from repro_torch.models.common import ParamDef  # noqa: E402
from repro_torch.sharding import axes  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402

ARCHS = j_registry.list_archs()
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")), ((8, 1), ("data", "model"))]


def _leaves(tree, path=""):
    if isinstance(tree, (ParamDef, JParamDef)):
        return [(path, tree)]
    return [x for k in sorted(tree) for x in _leaves(tree[k], f"{path}/{k}")]


def _defs(arch, smoke):
    return (_leaves(get_model(registry.get_config(arch, smoke=smoke)).param_defs()),
            _leaves(j_get_model(j_registry.get_config(arch, smoke=smoke)).param_defs()))


def _same_defs(mine, theirs):
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    for (path, d), (_, j) in zip(mine, theirs):
        assert (d.shape, d.axes, d.init, d.scale) == (tuple(j.shape), tuple(j.axes), j.init, j.scale), path


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_equal_jax(arch, smoke):
    _same_defs(*_defs(arch, smoke))


def test_xception_param_defs_equal_jax():
    for kw in ({}, {"width": 728, "n_blocks": 8}):
        _same_defs(_leaves(xception.param_defs(xception.XceptionConfig(**kw))),
                   _leaves(j_xception.param_defs(j_xception.XceptionConfig(**kw))))


def test_stack_defs_prepend_the_stack_axis():
    from repro_torch.models.common import STACK, stack_defs

    d = stack_defs({"w": ParamDef((4, 8), ("tp", None), scale=0.5)}, 3)["w"]
    assert (d.shape, d.axes, d.init, d.scale) == ((3, 4, 8), (STACK, "tp", None), "normal", 0.5)
    with pytest.raises(ValueError, match="axes"):
        ParamDef((4, 8), (None,))


def _ctxs(shape, names):
    return axes.make_ctx(axes.AbstractMesh(shape, names)), j_axes.make_ctx(JAbstractMesh(shape, names))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])) if isinstance(m, tuple) else None)
def test_mesh_ctx_equals_jax(mesh):
    ctx, jctx = _ctxs(*mesh)
    assert (ctx.batch_axes, ctx.tp_axis, ctx.fsdp_axis) == (jctx.batch_axes, jctx.tp_axis, jctx.fsdp_axis)
    assert (ctx.tp_size, ctx.dp_size, ctx.n_devices) == (jctx.tp_size, jctx.dp_size, jctx.n_devices)
    for b in range(1, 33):
        assert ctx.batch_spec_for(b) == jctx.batch_spec_for(b), b
        assert tuple(ctx.data_spec(b, 3)) == tuple(jctx.data_spec(b, 3)), b
    for a in (None, "model", "data", ("data", "model"), ctx.batch_axes):
        assert ctx.size_of(a) == jctx.size_of(a), a
    assert axes.make_ctx(None) is None


@pytest.mark.parametrize("fsdp", [False, True], ids=["nofsdp", "fsdp"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])) if isinstance(m, tuple) else None)
def test_rules_spec_for_equals_jax(mesh, fsdp):
    ctx, jctx = _ctxs(*mesh)
    rules, jrules = axes.Rules(ctx, fsdp_params=fsdp), j_axes.Rules(jctx, fsdp_params=fsdp)
    n = 0
    for arch in ARCHS:
        mine, theirs = _defs(arch, smoke=False)
        for (path, d), (_, j) in zip(mine, theirs):
            assert tuple(rules.spec_for(d)) == tuple(jrules.spec_for(j)), (arch, path)
            n += 1
    assert n > 200
    assert axes.Rules(None).spec_for(mine[0][1]) == axes.P()


def test_sharding_tree_records():
    """``sharding_tree`` gives None leaves without a ctx and otherwise a
    ``NamedSharding`` of the ctx's mesh and ``spec_for``'s spec; its blocks
    are checked against JAX's device indices in ``test_torch_mesh.py``."""
    defs = get_model(registry.get_config("dbrx-132b", smoke=True)).param_defs()
    assert all(v is None for _, v in _named(axes.Rules(None).sharding_tree(defs)))
    ctx = axes.make_ctx(axes.AbstractMesh((2, 4), ("data", "model")))
    rules = axes.Rules(ctx, fsdp_params=True)
    for (path, d), (_, s) in zip(_leaves(defs), _named(rules.sharding_tree(defs))):
        assert s.mesh is ctx.mesh and s.spec == rules.spec_for(d), path
    assert _named(rules.spec_tree(defs)) == [(p, rules.spec_for(d)) for p, d in _leaves(defs)]


def _named(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k], f"{path}/{k}")]
    return [(path, tree)]


# ---------------------------------------------------------------------------
# train/compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [256, 300])
def test_quantize_bit_exact_against_jax(n, dtype):
    x = (np.random.default_rng(n).standard_normal(n) * 3).astype(np.float32)
    x[128:256] = 0.0                                   # an all-zero block: the 1e-12 scale floor
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js, jpad = j_comp._quantize(jx)
    tq, ts, tpad = comp._quantize(tx)
    assert tpad == jpad == (-n) % 128
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(np.asarray(jq), tq.numpy()) and np.array_equal(np.asarray(js), ts.numpy())
    jd = j_comp._dequantize(jq, js, jpad, (n,))
    td = comp._dequantize(tq, ts, tpad, (n,))
    assert np.array_equal(np.asarray(jd), td.numpy())


def test_error_feedback_bit_exact_against_jax():
    """``ErrorFeedback.apply`` over 3 steps with an identity compress_fn:
    the sent gradients and carried residuals of both packages are equal."""
    rng = np.random.default_rng(0)
    steps = [{"a": rng.standard_normal((4, 70)).astype(np.float32),
              "b": {"c": rng.standard_normal((300,)).astype(np.float32)}} for _ in range(3)]
    dtypes = {"a": "float32", "c": "bfloat16"}

    def tree(g, to):
        return {"a": to(g["a"], dtypes["a"]), "b": {"c": to(g["b"]["c"], dtypes["c"])}}

    jres = j_comp.ErrorFeedback.init(tree(steps[0], lambda a, dt: jnp.asarray(a).astype(dt)))
    tres = comp.ErrorFeedback.init(tree(steps[0], lambda a, dt: torch.from_numpy(a).to(getattr(torch, dt))))
    assert tres["b"]["c"].dtype == torch.float32 and not tres["a"].any()
    for g in steps:
        jout, jres = j_comp.ErrorFeedback.apply(tree(g, lambda a, dt: jnp.asarray(a).astype(dt)), jres,
                                                lambda x: x)
        tout, tres = comp.ErrorFeedback.apply(tree(g, lambda a, dt: torch.from_numpy(a).to(getattr(torch, dt))),
                                              tres, lambda x: x)
        for j, t in ((jout["a"], tout["a"]), (jout["b"]["c"], tout["b"]["c"]),
                     (jres["a"], tres["a"]), (jres["b"]["c"], tres["b"]["c"])):
            assert str(j.dtype) == str(t.dtype).replace("torch.", "")
            assert np.array_equal(np.asarray(j.astype(jnp.float32)), t.float().numpy())
        assert float(np.abs(np.asarray(jres["a"])).max()) > 0
