"""One rank of ``test_torch_gspmd.py``'s gloo world on the CPU (imports torch
and the port only; started with the spawn method, one process a rank).

Each rank joins the world over a ``FileStore`` and builds the (2, 4) mesh
over ('data', 'model'). On JAX's test config (glm4-9b SMOKE, f32) it puts
the bridged parameters and f32 AdamW states on the mesh by the trees, takes
the sharded gradient (recording the CE's logits blocks), then four train
steps, and two with int8 AdamW states; runs the sharded argmax on two hidden batches (one with a tie
across vocab shards); saves the parameters under a (4, 2) mesh and
restores them under the (2, 4) one; and hands a DTensor to each kernel
wrapper; runs the sharded MoE body through ``local_map``; and trains 2
steps through ``Trainer`` with checkpoints, then resumes to 3. It writes
its blocks to ``rank{r}.npz`` and the rest to ``rank{r}.json`` in the
output directory.
"""
import json
import traceback
from pathlib import Path

import numpy as np

WORLD, TP = 8, 4
STEPS = 4
INT8_STEPS = 2
LR = 1e-3


def config():
    """JAX's test config: glm4-9b SMOKE (f32) at d 64, 4 heads over 2, d_ff
    128, attention chunks of 8, two CE chunks."""
    from repro_torch.configs.registry import get_config

    return get_config("glm4-9b", smoke=True).replace(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                                                      attn_chunk=8, ce_chunks=2)


def params_from(inputs: dict, prefix: str = "p"):
    """The port's parameter tree from the flat "p/<path>" arrays."""
    import torch

    from repro_torch.models import get_model

    defs = get_model(config()).param_defs()

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        return torch.from_numpy(np.array(inputs[f"{prefix}{path}"]))

    return walk(defs, "")


def _pl(t) -> str:
    return str(tuple(t.placements))


def run(rank: int, world: int, store_path: str, inputs_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import init_world, make_tier_mesh
    from repro_torch.launch.steps import (distribute_tree, make_train_step, opt_shardings, param_shardings,
                                          value_and_grad)
    from repro_torch.models import get_model
    from repro_torch.models import loss as loss_mod
    from repro_torch.models.transformer import batch_sharded
    from repro_torch.sharding.axes import coordinate, make_ctx
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.tree import leaves, paths

    torch.set_num_threads(1)
    out, info = {}, {"rank": rank}
    try:
        init_world("gloo", rank, world, dist.FileStore(store_path, world), timeout_s=120.0, device="cpu")
        inputs = dict(np.load(inputs_path))
        mesh = make_tier_mesh(world, TP, device="cpu")
        ctx = make_ctx(mesh)
        info["coord"] = coordinate(mesh)
        cfg = config()
        model = get_model(cfg)
        params = params_from(inputs)
        batch = {"tokens": torch.from_numpy(inputs["tokens"]), "labels": torch.from_numpy(inputs["labels"])}
        ocfg = OptConfig(lr=LR)
        psh, osh = param_shardings(model, ctx, fsdp=True), opt_shardings(model, ctx, ocfg)
        dp = distribute_tree(params, psh)
        dopt = distribute_tree(init_opt_state(params, ocfg), osh)
        info["placements"] = {f"{k}{p}": _pl(t) for k, tree in (("param", dp), ("m", dopt["m"]), ("v", dopt["v"]))
                              for p, t in zip(paths(tree), leaves(tree))}
        info["placements"]["step"] = _pl(dopt["step"])
        info["local_shapes"] = {f"param{p}": list(t.to_local().shape) for p, t in zip(paths(dp), leaves(dp))}

        shapes = []
        orig = loss_mod.qeinsum

        def recording(x, w):
            y = orig(x, w)
            shapes.append(list(y.shape))
            return y

        loss_mod.qeinsum = recording
        try:
            (loss, _), grads = value_and_grad(model, dp, batch, ctx)
        finally:
            loss_mod.qeinsum = orig
        info["logits_blocks"] = shapes
        info["loss"] = float(loss)
        info["grad_placements"] = {p: _pl(g) for p, g in zip(paths(grads), leaves(grads))}
        out.update({f"grad{p}": g.to_local().detach().numpy() for p, g in zip(paths(grads), leaves(grads))})

        step = make_train_step(model, ocfg, ctx=ctx)
        losses, p_, o_ = [], dp, dopt
        for _ in range(STEPS):
            p_, o_, metrics = step(p_, o_, batch)
            losses.append(float(metrics["loss"]))
        info["losses"] = losses
        info["after_placements"] = {p: _pl(t) for p, t in zip(paths(p_), leaves(p_))}

        ocfg8 = OptConfig(lr=LR, state_dtype="int8")
        step8, p8 = make_train_step(model, ocfg8, ctx=ctx), dp
        o8 = distribute_tree(init_opt_state(params, ocfg8), opt_shardings(model, ctx, ocfg8))
        info["int8_losses"] = []
        for _ in range(INT8_STEPS):
            p8, o8, metrics = step8(p8, o8, batch)
            info["int8_losses"].append(float(metrics["loss"]))
        info["int8_placements"] = {f"{k}{p}": _pl(t) for k in ("m", "v") for p, t in zip(paths(o8[k]), leaves(o8[k]))}
        out.update({f"int8/param{p}": t.to_local().numpy() for p, t in zip(paths(p8), leaves(p8))})
        out.update({f"int8/{k}{p}": t.to_local().numpy() for k in ("m", "v")
                    for p, t in zip(paths(o8[k]), leaves(o8[k]))})

        for name in ("argmax", "tie"):
            tree = params_from(inputs, "tie/p") if name == "tie" else params
            h = batch_sharded(ctx, torch.from_numpy(inputs[f"{name}/hidden"]))
            tok = loss_mod.next_tokens(cfg, distribute_tree(tree, psh), h, ctx=ctx)
            out[f"{name}/tokens"] = tok.to_local().numpy()
            tok_all = loss_mod.next_tokens_all(cfg, distribute_tree(tree, psh), h, ctx=ctx)
            out[f"{name}/tokens_all"] = tok_all.to_local().numpy()

        mesh_a = DeviceMesh("cpu", torch.arange(world).reshape(world // 2, 2), mesh_dim_names=("data", "model"))
        saved = distribute_tree(params, param_shardings(model, make_ctx(mesh_a), fsdp=True))
        ckpt.save(str(Path(out_dir) / "ckpt"), 1, saved)
        back = ckpt.restore(str(Path(out_dir) / "ckpt"), 1, params, shardings=psh)
        info["restored_placements"] = {p: _pl(t) for p, t in zip(paths(back), leaves(back))}
        info["restored_mesh"] = [list(t.device_mesh.shape) for t in leaves(back)][0]
        out.update({f"restored{p}": t.to_local().numpy() for p, t in zip(paths(back), leaves(back))})

        info["refused"] = _refusals(torch, dp, h)
        out.update(_moe(torch, ctx))
        info["trainer"] = trainer_losses(model, ctx, str(Path(out_dir) / "trainer"))
        out.update(_staged(torch, rank, world))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        info["error"] = traceback.format_exc()
        raise
    finally:
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(info))


def trainer_losses(model, ctx, ckpt_dir=None) -> dict:
    """``Trainer`` over ``ctx`` (None: one process): 2 steps checkpointed
    every step, then a fresh trainer to 3 steps resuming from the last
    checkpoint; each run's losses by step (without ``ckpt_dir`` one straight
    run of 3 steps)."""
    from repro_torch.train.data import DataConfig
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import TrainConfig, Trainer

    dcfg = DataConfig(batch_size=4, seq_len=16, vocab_size=model.cfg.vocab_size, seed=3)

    def run(steps, every):
        tcfg = TrainConfig(steps=steps, ckpt_every=every, ckpt_dir=ckpt_dir, log_every=1, opt=OptConfig(lr=LR))
        r = Trainer(model, tcfg, dcfg, device="cpu", ctx=ctx).run(seed=0)
        return {int(h["step"]): h["loss"] for h in r["history"]}

    if ckpt_dir is None:
        return {"straight": run(3, 10)}
    return {"first": run(2, 1), "resumed": run(3, 10)}


def _staged(torch, rank: int, world: int) -> dict:
    """DTensor's functional collectives through a ``sharding.staged`` group
    of the whole world (host tensors go straight through its CPU gloo
    group): all-gather, reduce-scatter, all-reduce and all-to-all of
    ``arange(2 * world) + rank``."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    from repro_torch.sharding import staged

    staged.register()
    g = dist.new_group(backend=staged.STAGED)
    x = torch.arange(2.0 * world) + rank
    return {"staged/all_gather": funcol.all_gather_tensor(x, 0, g).wait().numpy(),
            "staged/reduce_scatter": funcol.reduce_scatter_tensor(x, "sum", 0, g).wait().numpy(),
            "staged/all_reduce": funcol.all_reduce(x, "sum", g).wait().numpy(),
            "staged/all_to_all": funcol.all_to_all_single(x, None, None, g).wait().numpy(),
            "staged/backend": np.array(type(g).__name__)}


def _moe(torch, ctx) -> dict:
    """The MoE layer of ``tests/test_multidevice.py`` (4 experts top 2, d
    16, f 32, f32) at the default capacity factor with ``fsdp_experts``:
    ``moe_ffn_sharded`` on DTensor leaves laid out by the rules and a
    batch-sharded DTensor x, beside the explicit sharded ``moe_ffn`` on the
    rank's ``moe_blocks``; and whether a gradient through it raises."""
    from repro_torch.models import moe
    from repro_torch.models.common import MoECfg, ModelConfig, init_tree
    from repro_torch.models.transformer import batch_sharded
    from repro_torch.sharding.axes import NamedSharding, Rules

    cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, d_ff=32,
                      vocab_size=64, moe=MoECfg(n_experts=4, top_k=2, fsdp_experts=True),
                      param_dtype=torch.float32, compute_dtype=torch.float32)
    defs = moe.moe_defs(cfg)
    p = init_tree(torch.Generator().manual_seed(5), defs, torch.float32, "cpu")
    x = torch.randn(4, 6, 16, generator=torch.Generator().manual_seed(6))
    rules = Rules(ctx, fsdp_params=True)
    pd = {k: NamedSharding(ctx.mesh, rules.spec_for(d)).distribute(p[k]) for k, d in defs.items()}
    with torch.no_grad():
        y, aux = moe.moe_ffn_sharded(cfg, ctx, pd, batch_sharded(ctx, x))
    p_l, x_l, _ = moe.moe_blocks(cfg, ctx, p, x)
    want, want_aux = moe.moe_ffn(cfg, p_l, x_l, ctx=ctx, batch=4)
    try:
        moe.moe_ffn_sharded(cfg, ctx, {k: t.requires_grad_(True) for k, t in pd.items()}, batch_sharded(ctx, x))
        raised = 0
    except NotImplementedError:
        raised = 1
    return {"moe/out": y.to_local().numpy(), "moe/aux": aux.to_local().numpy(), "moe/want": want.numpy(),
            "moe/want_aux": want_aux.numpy(), "moe/placements": np.array(str(tuple(y.placements))),
            "moe/raised": np.array(raised)}


def _refusals(torch, dp, h) -> dict:
    """Each kernel wrapper handed a DTensor: the TypeError's text, or what
    it returned instead."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mlstm_chunk import ops as mk
    from repro_torch.kernels.paged_attention import ops as pa
    from repro_torch.kernels.rmsnorm import ops as rms

    q4 = h[:, :, None, :16]                        # (B, S, 1, 16), a DTensor
    z = torch.zeros(4, dtype=torch.int32)
    calls = {
        "rmsnorm": lambda: rms.rmsnorm(h, dp["final_norm"]["w"]),
        "flash_attention": lambda: fa.flash_attention(q4, q4, q4),
        "flash_attention_bhsd": lambda: fa.flash_attention_bhsd(q4, q4, q4),
        "decode_attention": lambda: da.decode_attention(q4[:, :1], q4, q4, 3),
        "paged_attention": lambda: pa.paged_attention(q4[:, :1], q4, q4, z[:, None], z),
        "paged_prefill_write": lambda: pa.paged_prefill_write(q4, q4, q4, q4, z),
        "paged_prefill_write_quant": lambda: pa.paged_prefill_write_quant(q4, q4, q4, q4, q4, q4, z),
        "mlstm_chunkwise": lambda: mk.mlstm_chunkwise_bh(q4[..., 0, :], q4[..., 0, :], q4[..., 0, :],
                                                        q4[..., 0, 0], q4[..., 0, 0], None, None, None),
    }
    got = {}
    for name, fn in calls.items():
        try:
            fn()
            got[name] = "returned"
        except TypeError as e:
            got[name] = f"TypeError: {e}"
    return got
