"""Quickstart: the public API in ~60 lines — the twin of
``examples/quickstart.py``: the training loss, prefill and decode of
glm4-9b (smoke) on ``--device`` (default the card), Algorithm 1 on one
request, and the paper testbed under a 2,000-session ramp through
StraightLine.

    PYTHONPATH=src python -m repro_torch.launch.quickstart              # on the card
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

The port cannot replay ``jax.random``: its weights come from a seeded
``torch.Generator`` and its tokens and labels from numpy.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core import Request, SimConfig, Simulation, StraightLinePolicy, Thresholds
from repro_torch.core.testbed import paper_tiers
from repro_torch.core.workload import ramp
from repro_torch.models import get_model
from repro_torch.models.common import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="device of the model (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)
    print("assigned architectures:", ", ".join(list_archs()))

    # --- 1. any architecture, one API -----------------------------------------
    cfg = get_config("glm4-9b", smoke=True)          # structurally-faithful reduction
    model = get_model(cfg)
    params = model.init(torch.Generator(dev).manual_seed(0))
    batch = {
        "tokens": np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16)),
        "labels": np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16)),
    }
    loss, _ = model.loss(params, batch)
    print(f"glm4-9b (smoke) train loss: {float(loss):.3f}")

    # --- 2. prefill + decode ------------------------------------------------
    tok, cache = model.prefill(params, {"tokens": batch["tokens"]}, cap=24)
    tok2, cache = model.decode(params, cache, {"token": tok[:, None], "cache_index": 16})
    print("greedy next tokens:", tok.tolist(), "->", tok2.tolist())

    # --- 3. StraightLine: Algorithm 1 ----------------------------------------
    pol = StraightLinePolicy(Thresholds(F=1200, D=1e6))
    d = pol.place(Request(rid=0, arrival_t=0.0, data_size=2e5), f_t=2000, flask_free=1, docker_free=1)
    print(f"burst+small payload -> {d.tier.name}  ({d.reason})")

    # --- 4. the hybrid testbed under a paper-style ramp ------------------------
    sim = Simulation(pol, paper_tiers(seed=0), SimConfig())
    summary = sim.run(ramp(2000, seed=0)).summary()
    print("2000-session ramp through StraightLine:", summary)
    return {"loss": float(loss), "params": params, "batch": batch, "tokens": tok.tolist(),
            "next_tokens": tok2.tolist(), "decision": d, "summary": summary}


if __name__ == "__main__":
    main()
