"""One rank of ``test_torch_mesh.py``'s gloo world on the CPU (imports torch
and the port only; started with the spawn method, one process a rank).

Each rank joins the world over a ``FileStore``, builds the meshes, cuts its
blocks of every MoE case's full layer and batch (``moe.moe_blocks``), runs
the sharded ``moe_ffn`` and the compressed psum, and writes its results to
``rank{r}.npz`` and ``rank{r}.json`` in the output directory.
"""
import json
import traceback
from pathlib import Path

import numpy as np

D_MODEL, D_FF = 16, 32


def moe_config(case: dict):
    """The port's config of a case (the JAX tests' layer: d 16, f 32, f32)."""
    import torch

    from repro_torch.models.common import MoECfg, ModelConfig

    return ModelConfig(name="m", family="moe", n_layers=1, d_model=D_MODEL, n_heads=2, n_kv_heads=2,
                       d_ff=D_FF, vocab_size=64,
                       moe=MoECfg(n_experts=case["E"], top_k=case["k"], capacity_factor=case["cf"],
                                  fsdp_experts=case["fsdp"]),
                       param_dtype=torch.float32, compute_dtype=torch.float32, moe_token_gather=case["tok"])


def layer(inputs, case: dict):
    """(params, x, valid) of a case as torch tensors: the int8 leaves as
    {"q", "s"} dicts with bf16 scales (stored as uint16)."""
    import torch

    n = case["name"]

    def t(key):
        return torch.from_numpy(np.array(inputs[f"{n}/{key}"]))

    p = {"router": t("router")}
    for w in ("w1", "w2", "w3"):
        p[w] = {"q": t(f"{w}/q"), "s": t(f"{w}/s").view(torch.bfloat16)} if case["int8"] else t(w)
    return p, t("x"), t("valid") if case["mask"] else None


def run(rank: int, world: int, store_path: str, inputs_path: str, meta_path: str, out_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import init_world, make_production_mesh, make_tier_mesh
    from repro_torch.models import moe
    from repro_torch.sharding.axes import P, coordinate, make_ctx
    from repro_torch.train.compression import make_compressed_psum

    torch.set_num_threads(1)
    out, info = {}, {"rank": rank}
    try:
        init_world("gloo", rank, world, dist.FileStore(store_path, world), timeout_s=60.0, device="cpu")
        cases = json.loads(Path(meta_path).read_text())
        inputs = dict(np.load(inputs_path))
        tier = make_tier_mesh(world, 4, device="cpu")
        info["tier"] = {"shape": list(tier.shape), "names": list(tier.mesh_dim_names),
                        "coord": coordinate(tier)}
        try:
            make_production_mesh(device="cpu")
        except RuntimeError as e:
            info["production"] = str(e)
        meshes = {"2x4": tier, "2x2x2": init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))}
        for case in cases:
            mesh = meshes[case["mesh"]]
            ctx = make_ctx(mesh)
            cfg = moe_config(case)
            p, x, valid = layer(inputs, case)
            p_l, x_l, v_l = moe.moe_blocks(cfg, ctx, p, x, valid)
            y, aux = moe.moe_ffn(cfg, p_l, x_l, v_l, ctx=ctx, batch=x.shape[0])
            out[f"{case['name']}/out"] = y.numpy()
            out[f"{case['name']}/aux"] = aux.numpy()
            info[case["name"]] = coordinate(mesh)
        pod = init_device_mesh("cpu", (world,), mesh_dim_names=("pod",))
        x = torch.from_numpy(inputs["psum/x"])
        fn = make_compressed_psum(pod, "pod", P("pod", None))
        out["psum/out"] = fn(x[rank:rank + 1]).numpy()
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        info["error"] = traceback.format_exc()
        raise
    finally:
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
        Path(out_dir, f"rank{rank}.json").write_text(json.dumps(info))
