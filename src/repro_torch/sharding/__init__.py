from repro_torch.sharding.axes import MeshCtx, Rules, make_ctx

__all__ = ["MeshCtx", "Rules", "make_ctx"]
