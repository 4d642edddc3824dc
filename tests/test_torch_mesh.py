"""The port's mesh path on 8 gloo ranks on the CPU against the JAX package's
8-device ``shard_map`` results.

One module-wide run: the inputs are made here from a numpy seed (int8
expert leaves by JAX's ``quantize_params``); a JAX subprocess with 8 forced
host devices (as ``tests/test_multidevice.py`` runs them) computes JAX's
sharded MoE outputs, compressed psum and device indices, while a world of
8 spawned torch ranks over a ``FileStore`` (``torch_mesh_ranks.py``) runs
the port's. Held: every rank's output block and aux against JAX's at f32
2e-5, and against the single-device oracle of the same semantics (the
rank's batch shard for the weight gather, the whole batch for the token
gather) at 2e-5, and the JAX tests' cases at their own bounds against the
whole-batch oracle; the compressed psum bit for bit; the blocks a rank cuts
against JAX's device indices; the tier and production meshes.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.quant import quantize_params as j_quantize_params  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.sharding import axes  # noqa: E402
from torch_mesh_ranks import D_FF, D_MODEL, layer, moe_config  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
WORLD = 8
TOL = 2e-5
SPAWN_TIMEOUT_S = 300

# (name, mesh, experts, top-k, capacity factor, fsdp_experts, moe_token_gather, B, S, valid mask, int8 experts)
CASES = [dict(zip(("name", "mesh", "E", "k", "cf", "fsdp", "tok", "B", "S", "mask", "int8"), c)) for c in (
    ("shard", "2x4", 4, 2, 100.0, False, False, 4, 6, False, False),    # test_moe_shard_map_matches_single_device
    ("fsdp", "2x4", 4, 1, 100.0, True, False, 4, 6, False, False),      # test_moe_fsdp_expert_gather_matches
    ("token_w", "2x4", 4, 1, 100.0, True, False, 4, 2, False, False),   # test_moe_token_gather_matches_weight_gather
    ("token", "2x4", 4, 1, 100.0, True, True, 4, 2, False, False),
    ("binding", "2x4", 4, 2, 1.25, True, False, 4, 8, True, False),     # the default capacity factor binds
    ("binding_tok", "2x4", 4, 2, 1.25, True, True, 4, 8, True, False),
    ("int8", "2x4", 4, 2, 1.25, True, False, 4, 6, False, True),        # JAX's quantize_params leaves
    ("replicated", "2x4", 4, 2, 1.25, False, False, 3, 4, False, False),  # batch 3: not sharded
    ("pod", "2x2x2", 4, 2, 1.25, True, False, 4, 4, True, False),       # two batch axes
    ("pod_tok", "2x2x2", 4, 2, 1.25, True, True, 4, 4, True, False),
)]
JAX_TEST_CASES = {"shard", "fsdp", "token_w", "token"}
SAME_LAYER = {"token": "token_w"}          # the token gather and its weight-gather twin share inputs

JAX_SCRIPT = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import get_config
from repro.models import MoECfg, ModelConfig, get_model
from repro.models.moe import moe_ffn
from repro.sharding.axes import Rules, make_ctx
from repro.train.compression import make_compressed_psum

cases = json.load(open(sys.argv[1]))
inp = dict(np.load(sys.argv[2]))
meshes = {"2x4": jax.make_mesh((2, 4), ("data", "model")),
          "2x2x2": jax.make_mesh((2, 2, 2), ("pod", "data", "model"))}
out = {}
for c in cases:
    n = c["name"]
    cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=%(d)d, n_heads=2, n_kv_heads=2,
                      d_ff=%(f)d, vocab_size=64,
                      moe=MoECfg(n_experts=c["E"], top_k=c["k"], capacity_factor=c["cf"],
                                 fsdp_experts=c["fsdp"]),
                      param_dtype=jnp.float32, compute_dtype=jnp.float32, moe_token_gather=c["tok"])
    p = {"router": jnp.asarray(inp[n + "/router"])}
    for w in ("w1", "w2", "w3"):
        if c["int8"]:
            p[w] = {"q": jnp.asarray(inp[n + "/" + w + "/q"]),
                    "s": jnp.asarray(inp[n + "/" + w + "/s"].view(jnp.bfloat16))}
        else:
            p[w] = jnp.asarray(inp[n + "/" + w])
    valid = jnp.asarray(inp[n + "/valid"]) if c["mask"] else None
    ctx = make_ctx(meshes[c["mesh"]])
    y, aux = jax.jit(lambda p, x, v: moe_ffn(cfg, ctx, p, x, valid=v))(p, jnp.asarray(inp[n + "/x"]), valid)
    out[n + "/out"], out[n + "/aux"] = np.asarray(y), np.asarray(aux)

pod = jax.make_mesh((8,), ("pod",))
xs = jax.device_put(jnp.asarray(inp["psum/x"]), NamedSharding(pod, P("pod", None)))
out["psum/out"] = np.asarray(jax.jit(make_compressed_psum(pod, "pod", P("pod", None)))(xs))

# each leaf's index ranges at every (2, 4) mesh position, row-major
mesh = meshes["2x4"]
rules = Rules(make_ctx(mesh), fsdp_params=True)
defs = get_model(get_config("dbrx-132b", smoke=True)).param_defs()
flat = jax.tree_util.tree_flatten_with_path(defs, is_leaf=lambda x: hasattr(x, "axes"))[0]
pos = {d: i for i, d in enumerate(mesh.devices.reshape(-1))}
blocks = {}
for path, d in flat:
    spec = rules.spec_for(d)
    idx = NamedSharding(mesh, spec).devices_indices_map(d.shape)
    rows = [None] * len(pos)
    for dev, sl in idx.items():
        rows[pos[dev]] = [list(s.indices(n)[:2]) for s, n in zip(sl, d.shape)]
    blocks["/" + "/".join(k.key for k in path)] = {"spec": [list(a) if isinstance(a, tuple) else a for a in spec],
                                                    "rows": rows}
np.savez(sys.argv[3], **out)
json.dump(blocks, open(sys.argv[4], "w"))
""" % {"d": D_MODEL, "f": D_FF}


def _inputs(path: Path) -> dict:
    """Every case's full layer and batch from one numpy seed."""
    rng = np.random.default_rng(0)
    arrs = {}
    for c in CASES:
        n, E = c["name"], c["E"]
        if n in SAME_LAYER:
            arrs.update({k.replace(SAME_LAYER[n], n, 1): v for k, v in arrs.items()
                         if k.startswith(SAME_LAYER[n] + "/")})
            continue
        arrs[f"{n}/router"] = (rng.standard_normal((D_MODEL, E)) / np.sqrt(D_MODEL)).astype(np.float32)
        ws = {"w1": (E, D_MODEL, D_FF), "w3": (E, D_MODEL, D_FF), "w2": (E, D_FF, D_MODEL)}
        ws = {w: (rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32) for w, s in ws.items()}
        if c["int8"]:
            q = j_quantize_params({w: jnp.asarray(a) for w, a in ws.items()})
            for w in ws:
                arrs[f"{n}/{w}/q"] = np.asarray(q[w]["q"])
                arrs[f"{n}/{w}/s"] = np.asarray(q[w]["s"]).view(np.uint16)
        else:
            arrs.update({f"{n}/{w}": a for w, a in ws.items()})
        arrs[f"{n}/x"] = rng.standard_normal((c["B"], c["S"], D_MODEL)).astype(np.float32)
        if c["cf"] < 100:
            # a shared direction that favours expert 0: more tokens choose it than it has slots
            u = np.full(D_MODEL, 1.5 / np.sqrt(D_MODEL), np.float32)
            arrs[f"{n}/x"] += u
            arrs[f"{n}/router"][:, 0] += u
        lens = rng.integers(1, c["S"] + 1, size=c["B"])
        lens[0] = c["S"]
        arrs[f"{n}/valid"] = np.arange(c["S"])[None, :] < lens[:, None]
    arrs["psum/x"] = rng.standard_normal((WORLD, 256)).astype(np.float32)
    np.savez(path, **arrs)
    return arrs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import multiprocessing

    import torch_mesh_ranks

    tmp = tmp_path_factory.mktemp("mesh")
    inputs = _inputs(tmp / "inputs.npz")
    (tmp / "cases.json").write_text(json.dumps(CASES))
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    jax_run = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT, str(tmp / "cases.json"), str(tmp / "inputs.npz"),
                                str(tmp / "jax.npz"), str(tmp / "blocks.json")],
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_mesh_ranks.run,
                         args=(r, WORLD, str(tmp / "store"), str(tmp / "inputs.npz"), str(tmp / "cases.json"),
                               str(tmp)))
             for r in range(WORLD)]
    for pr in procs:
        pr.start()
    try:
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        for pr in procs:
            pr.join(max(1.0, deadline - time.monotonic()))
        stuck = [r for r, pr in enumerate(procs) if pr.is_alive()]
        _, jerr = jax_run.communicate(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    infos = [json.loads((tmp / f"rank{r}.json").read_text()) if (tmp / f"rank{r}.json").exists() else {}
             for r in range(WORLD)]
    errors = [i.get("error") for i in infos if i.get("error")]
    assert not stuck and all(pr.exitcode == 0 for pr in procs), (stuck, [pr.exitcode for pr in procs], errors)
    assert jax_run.returncode == 0, jerr[-3000:]
    return {"inputs": inputs, "jax": dict(np.load(tmp / "jax.npz")),
            "blocks": json.loads((tmp / "blocks.json").read_text()), "infos": infos,
            "ranks": [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]}


def _mesh(name):
    return {"2x4": axes.AbstractMesh((2, 4), ("data", "model")),
            "2x2x2": axes.AbstractMesh((2, 2, 2), ("pod", "data", "model"))}[name]


def _case_layer(runs, c):
    """The case's config, its layer and batch as torch tensors, and its
    abstract ctx (the rules' view of the ranks' mesh)."""
    p, x, valid = layer(runs["inputs"], c)
    return moe_config(c), p, x, valid, axes.make_ctx(_mesh(c["mesh"]))


def _rank_block(ctx, t, c, coord):
    """The rank's block of a full batch-major tensor (its batch shard)."""
    return axes.shard_block(t, axes.P(ctx.batch_spec_for(c["B"])), ctx.shape, coord)


def test_tier_and_production_meshes(runs):
    for r, info in enumerate(runs["infos"]):
        assert info["tier"]["shape"] == [2, 4] and info["tier"]["names"] == ["data", "model"]
        assert info["tier"]["coord"] == {"data": r // 4, "model": r % 4}
        assert "256" in info["production"] and "8" in info["production"], info["production"]


def test_blocks_equal_jax_device_indices(runs):
    """``NamedSharding.block`` at every (2, 4) position cuts the index
    ranges JAX's ``devices_indices_map`` gives that device, for every leaf
    of a SMOKE dbrx-132b tree under ``Rules(fsdp_params=True)``."""
    from repro_torch.configs import registry
    from repro_torch.models import get_model
    from repro_torch.models.common import is_def

    mesh = _mesh("2x4")
    rules = axes.Rules(axes.make_ctx(mesh), fsdp_params=True)
    shard = rules.sharding_tree(get_model(registry.get_config("dbrx-132b", smoke=True)).param_defs())

    def walk(node, path=""):
        if isinstance(node, axes.NamedSharding) or is_def(node):
            yield path, node
            return
        for k in sorted(node):
            yield from walk(node[k], f"{path}/{k}")

    seen = 0
    for path, s in walk(shard):
        want = runs["blocks"][path]
        assert [tuple(a) if isinstance(a, list) else a for a in want["spec"]] == list(s.spec), path
        full_shape = tuple(max(r[i][1] for r in want["rows"]) for i in range(len(want["rows"][0])))
        full = torch.arange(int(np.prod(full_shape))).reshape(full_shape)
        for pos, rows in enumerate(want["rows"]):
            coord = {"data": pos // 4, "model": pos % 4}
            expect = full[tuple(slice(a, b) for a, b in rows)]
            assert torch.equal(s.block(full, coord), expect), (path, coord)
        seen += 1
    assert seen == len(runs["blocks"]) > 10


@pytest.mark.parametrize("c", CASES, ids=[c["name"] for c in CASES])
def test_moe_ranks_equal_jax_shard_map(runs, c):
    """Each rank's output block and aux against JAX's sharded output,
    sliced to the rank's batch shard, at f32 2e-5."""
    n = c["name"]
    _, _, _, _, ctx = _case_layer(runs, c)
    jout, jaux = torch.from_numpy(runs["jax"][f"{n}/out"]), float(runs["jax"][f"{n}/aux"])
    for r, got in enumerate(runs["ranks"]):
        coord = runs["infos"][r][n]
        want = _rank_block(ctx, jout, c, coord)
        assert got[f"{n}/out"].shape == tuple(want.shape)
        assert np.max(np.abs(got[f"{n}/out"] - want.numpy())) < TOL, (n, r)
        assert abs(float(got[f"{n}/aux"]) - jaux) < TOL, (n, r)


@pytest.mark.parametrize("c", CASES, ids=[c["name"] for c in CASES])
def test_moe_ranks_equal_single_device_oracle(runs, c):
    """The oracle of the same semantics at f32 2e-5: the weight gather is
    the single-device layer on the rank's batch shard (capacity from its own
    token count; the aux the mean of the shards' auxes), the token gather
    the single-device layer on the whole batch, sliced to the rank. The JAX
    tests' cases also against the whole-batch oracle at their bounds (out
    1e-4; aux within half of it under the weight gather)."""
    n = c["name"]
    cfg, p, x, valid, ctx = _case_layer(runs, c)
    whole, whole_aux = moe.moe_ffn(cfg, p, x, valid)
    if c["cf"] < 100:                       # the capacity really binds: some assignment is dropped
        xf = x.reshape(-1, D_MODEL)
        r = moe.route(cfg, xf @ p["router"], moe.capacity_for(cfg, xf.shape[0]),
                      None if valid is None else valid.reshape(-1))
        assert int(r["assigned"].sum()) > int(r["sel_valid"].sum()), n
    shard_auxes = {}
    for r, got in enumerate(runs["ranks"]):
        coord = runs["infos"][r][n]
        if c["tok"]:
            want, want_aux = _rank_block(ctx, whole, c, coord), whole_aux
        else:
            xs = _rank_block(ctx, x, c, coord)
            vs = None if valid is None else _rank_block(ctx, valid, c, coord)
            want, aux = moe.moe_ffn(cfg, p, xs, vs)
            shard_auxes[tuple(coord[a] for a in ctx.batch_axes)] = float(aux)
        assert np.max(np.abs(got[f"{n}/out"] - want.numpy())) < TOL, (n, r)
        if c["tok"]:
            assert abs(float(got[f"{n}/aux"]) - float(want_aux)) < TOL, (n, r)
        if n in JAX_TEST_CASES:
            assert np.max(np.abs(got[f"{n}/out"] - _rank_block(ctx, whole, c, coord).numpy())) < 1e-4, (n, r)
    if not c["tok"]:
        mean = sum(shard_auxes.values()) / len(shard_auxes)
        for got in runs["ranks"]:
            assert abs(float(got[f"{n}/aux"]) - mean) < TOL, n
        if n == "shard":
            assert abs(mean - float(whole_aux)) / float(whole_aux) < 0.5
    if n == "token":                       # test_moe_token_gather_matches_weight_gather's bound
        for got in runs["ranks"]:
            assert np.max(np.abs(got["token/out"] - got["token_w/out"])) < 1e-4


def test_compressed_psum_equals_jax(runs):
    """Each rank's all-reduced row equals JAX's loop run op by op (each
    row's ``_quantize``, then ``_dequantize`` and add in rank order) bit for
    bit, every rank the same, within 0.05 relative of the true sum. JAX's
    compiled ``shard_map`` is within one int8 step of it: XLA rewrites the
    division by 127 as a multiply by its reciprocal and fuses each
    dequantize-and-add into a multiply-add."""
    from repro.train import compression as j_comp

    x = runs["inputs"]["psum/x"]
    loop, step = jnp.zeros((1, x.shape[1]), jnp.float32), 0.0
    for r in range(WORLD):
        q, s, pad = j_comp._quantize(jnp.asarray(x[r:r + 1]))
        loop = loop + j_comp._dequantize(q, s, pad, (1, x.shape[1]))
        step += float(s.max())
    rows = np.concatenate([r["psum/out"] for r in runs["ranks"]])
    assert np.array_equal(rows, np.broadcast_to(np.asarray(loop), rows.shape))
    want = np.broadcast_to(x.sum(0, keepdims=True), x.shape)
    assert np.max(np.abs(rows - want)) / np.max(np.abs(want)) < 0.05
    assert np.max(np.abs(rows - runs["jax"]["psum/out"])) <= step
