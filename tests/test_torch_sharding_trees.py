"""The port's sharding trees (``launch/steps.py``, ``models/quant.py``)
against the JAX package's, in one process on ``AbstractMesh``es.

For every configuration, FULL and SMOKE, on the meshes (16, 16), (2, 16,
16), (2, 4) and (8, 1): ``param_shardings`` with FSDP off and on,
``batch_shardings`` of the train, prefill and decode inputs at a batch the
mesh divides and one it does not, ``cache_shardings`` of the dense decode
cache, ``opt_shardings`` for f32, bf16 and int8 states, and
``quantized_sharding_tree`` of the serving tree give JAX's PartitionSpec
leaf for leaf; every spec's DTensor placements shard each tensor dim over
the mesh axes the spec names, outermost first. The trees run sharded in
``test_torch_gspmd.py``.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.launch import steps as j_steps  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models.api import ShapeSpec as JShapeSpec  # noqa: E402
from repro.models.quant import quantized_sharding_tree as j_quantized_sharding_tree  # noqa: E402
from repro.sharding import axes as j_axes  # noqa: E402
from repro.train.optimizer import OptConfig as JOptConfig  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.api import ShapeSpec  # noqa: E402
from repro_torch.models.quant import quantized_sharding_tree  # noqa: E402
from repro_torch.sharding import axes  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402

ARCHS = j_registry.list_archs()
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")), ((8, 1), ("data", "model"))]
STATES = ("float32", "bfloat16", "int8")


def _spec(s) -> tuple:
    """A sharding's spec as a tuple, one-name tuples as the name, trailing
    Nones dropped (the same layout); None for no sharding."""
    if s is None:
        return None
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else (tuple(e) if isinstance(e, tuple) else e)
           for e in s.spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _flat(tree, path=""):
    """(path, leaf) pairs of a nested dict, keys sorted (either package's
    sharding leaves, None included)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], f"{path}/{k}")]
    return [(path, tree)]


def _same(mine, theirs, what):
    m, t = _flat(mine), _flat(theirs)
    assert [p for p, _ in m] == [p for p, _ in t], what
    for (path, a), (_, b) in zip(m, t):
        assert _spec(a) == _spec(b), (what, path, _spec(a), _spec(b))
    return len(m)


def _models(arch, smoke):
    return (get_model(registry.get_config(arch, smoke=smoke)),
            j_get_model(j_registry.get_config(arch, smoke=smoke)))


def _check_placements(tree, mesh):
    """Every NamedSharding's placements shard each tensor dim over the mesh
    axes its spec names, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    for path, s in _flat(tree):
        if s is None:
            continue
        pl = s.placements
        assert len(pl) == len(names), path
        want = [Replicate()] * len(names)
        for dim, e in enumerate(s.spec):
            for a in ((e,) if isinstance(e, str) else (e or ())):
                want[names.index(a)] = Shard(dim)
        assert list(pl) == want, (path, pl, want)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_trees_equal_jax(arch, smoke, mesh):
    shape, names = mesh
    am = axes.AbstractMesh(shape, names)
    ctx, jctx = axes.make_ctx(am), j_axes.make_ctx(JAbstractMesh(shape, names))
    model, jmodel = _models(arch, smoke)
    n = 0
    for fsdp in (False, True):
        psh = steps.param_shardings(model, ctx, fsdp)
        n += _same(psh, j_steps.param_shardings(jmodel, jctx, fsdp), f"params fsdp={fsdp}")
        _check_placements(psh, am)
    dp = ctx.dp_size
    for kind in ("train", "prefill", "decode"):
        for B in (2 * dp, 3):
            spec, jspec = ShapeSpec("t", kind, 64, B), JShapeSpec("t", kind, 64, B)
            n += _same(steps.batch_shardings(ctx, model.input_specs(spec), B),
                       j_steps.batch_shardings(jctx, jmodel.input_specs(jspec), B), f"batch {kind} {B}")
    csh = steps.cache_shardings(ctx, model.cache_defs(2 * dp, 64))
    n += _same(csh, j_steps.cache_shardings(jctx, jmodel.cache_defs(2 * dp, 64)), "cache")
    _check_placements(csh, am)
    for dt in STATES:
        osh = steps.opt_shardings(model, ctx, OptConfig(state_dtype=dt))
        n += _same(osh, j_steps.opt_shardings(jmodel, jctx, JOptConfig(state_dtype=dt)), f"opt {dt}")
        _check_placements(osh, am)
    qsh = quantized_sharding_tree(steps.param_shardings(model, ctx, False), model.param_shapes())
    n += _same(qsh, j_quantized_sharding_tree(j_steps.param_shardings(jmodel, jctx, False), jmodel.param_shapes()),
               "quantized")
    assert n > 20


@pytest.mark.parametrize("arch", ARCHS)
def test_sharding_trees_without_a_mesh_are_none(arch):
    """ctx None: every tree's leaves are None, as JAX's; int8 states a
    {"q", "scale"} pair of them."""
    model, jmodel = _models(arch, True)
    _same(steps.param_shardings(model, None, True), j_steps.param_shardings(jmodel, None, True), "params")
    for dt in STATES:
        _same(steps.opt_shardings(model, None, OptConfig(state_dtype=dt)),
              j_steps.opt_shardings(jmodel, None, JOptConfig(state_dtype=dt)), f"opt {dt}")
    spec = ShapeSpec("t", "train", 16, 2)
    assert steps.batch_shardings(None, model.input_specs(spec), 2) == {k: None for k in model.input_specs(spec)}
    _same(steps.cache_shardings(None, model.cache_defs(2, 16)), j_steps.cache_shardings(None, jmodel.cache_defs(2, 16)),
          "cache")


def test_placements_refuse_an_axis_order_dtensor_cannot_hold():
    mesh = axes.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert axes.placements(axes.P(("pod", "data"), "model"), mesh)[2].dim == 1
    with pytest.raises(ValueError, match="axis order"):
        axes.placements(axes.P(("data", "pod")), mesh)
