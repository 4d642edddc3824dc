"""Twins of the JAX package's paper-figure benchmarks (``benchmarks/``):
the same ``name,us,derived`` rows at the same loads and seeds, through the
port's simulator. Run one with

    PYTHONPATH=src python -m repro_torch.benchmarks.fig4_interactive
    PYTHONPATH=src python -m repro_torch.benchmarks.placement --device cpu

``placement`` times the vectorized placer on ``--device`` (default the card).
"""
