"""The port's CUDA kernels against their plain PyTorch versions, through the
``ops.py`` wrappers, and the paged engine on the card against the engine on
the CPU. These tests carry the ``cuda`` marker and skip where there is no
card; on a machine with one run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch only, so it runs on a machine without JAX. One test
runs everywhere: on a CPU tensor a wrapper takes its plain version and
neither builds nor counts a kernel launch."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref, paged_prefill_write_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}      # tests/test_kernels.py:17
WRAPPERS = (rms_ops.rmsnorm, pa_ops.paged_prefill_write, pa_ops.paged_attention,
            fa_ops.flash_attention_bhsd)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_cpu_tensors_take_the_plain_versions():
    before = [w.launches for w in WRAPPERS]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 40, generator=g)
    assert torch.equal(rms_ops.rmsnorm(x, torch.ones(40)), rmsnorm_ref(x, torch.ones(40)))
    pk, pv = torch.zeros(4, 1, 2, 8), torch.zeros(4, 1, 2, 8)
    k = torch.randn(1, 3, 1, 8, generator=g)
    pa_ops.paged_prefill_write(pk, pv, k, k, torch.tensor([2, 3], dtype=torch.int32))
    assert torch.equal(pk[2], k[0, :2].transpose(0, 1)) and torch.equal(pk[3, :, 0], k[0, 2])
    q = torch.randn(1, 2, 5, 8, generator=g)
    assert torch.equal(fa_ops.flash_attention_bhsd(q, q[:, :1], q[:, :1]),
                       attention_ref(q, q[:, :1], q[:, :1]))
    assert [w.launches for w in WRAPPERS] == before


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_device):
    """Each kernel at the serving path's widths (D = 960, KV = 5, G = 3,
    hd = 64, 16-token pages), with a ragged write, a dead slot, a
    page-boundary length and a ragged S."""
    dev = cuda_device
    g = torch.Generator(dev).manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[dt]

        def r(*s):
            return torch.randn(s, generator=g, device=dev).to(dt)

        x, w = r(8, 960), torch.linspace(0.5, 1.5, 960, device=dev).to(dt)
        assert (rms_ops.rmsnorm(x, w).float() - rmsnorm_ref(x, w).float()).abs().max() < tol
        pk, pv, k, v = r(9, 5, 16, 64), r(9, 5, 16, 64), r(1, 40, 5, 64), r(1, 40, 5, 64)
        row = torch.tensor([3, 8, 1, 0], dtype=torch.int32, device=dev)
        ck, cv = pa_ops.paged_prefill_write(pk.clone(), pv.clone(), k, v, row)
        rk, rv = paged_prefill_write_ref(pk.clone(), pv.clone(), k, v, row)
        assert torch.equal(ck[1:], rk[1:]) and torch.equal(cv[1:], rv[1:])
        assert torch.equal(ck[2], pk[2]) and torch.equal(ck[4:8], pk[4:8])   # untouched
        q = r(4, 1, 15, 64)
        tab = torch.tensor([[0, 0, 0], [1, 2, 3], [4, 5, 6], [7, 8, 1]], dtype=torch.int32, device=dev)
        lens = torch.tensor([1, 16, 33, 48], dtype=torch.int32, device=dev)
        out = pa_ops.paged_attention(q, pk, pv, tab, lens).reshape(4, 5, 3, 64)
        ref = paged_attention_ref(q[:, 0].reshape(4, 5, 3, 64), pk, pv, tab, lens)
        assert torch.isfinite(out.float()).all()
        assert (out.float() - ref.float()).abs().max() < tol
        q, k, v = r(1, 15, 40, 64), r(1, 5, 40, 64), r(1, 5, 40, 64)
        assert (fa_ops.flash_attention_bhsd(q, k, v).float()
                - attention_ref(q, k, v).float()).abs().max() < tol
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_tokens", [0, 16], ids=["whole_prompt", "chunked"])
def test_cuda_engine_matches_cpu_engine(cuda_device, chunk_tokens):
    """The paged engine on the card (every kernel of the path) and on the
    CPU (every plain version), smollm-360m SMOKE in f32 on the same weights:
    identical greedy streams; a flip reports the CPU's top-2 logit gap."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model
    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine

    cfg = get_config("smollm-360m", smoke=True).replace(attn_chunk=64)
    model = get_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    gpu_params = _map(cpu_params, lambda t: t.to(cuda_device))
    kw = dict(page_size=8, num_pages=33, max_slots=3, max_seq_len=64, max_new_tokens=6,
              chunk_tokens=chunk_tokens)
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist() for n in (5, 19, 30, 8)]
    want = [s.out for s in PagedInferenceEngine(cfg, PagedEngineConfig(**kw), params=cpu_params,
                                                device="cpu").generate(prompts)]
    got = [s.out for s in PagedInferenceEngine(cfg, PagedEngineConfig(**kw), params=gpu_params,
                                               device=cuda_device).generate(prompts)]
    for prompt, a, b in zip(prompts, want, got):
        if a != b:
            j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            with torch.no_grad():
                row = model.logits(cpu_params, model.hidden(cpu_params, [prompt + a[:j]]))[0, -1]
            top2 = torch.topk(row, 2).values
            pytest.fail(f"token {j} differs (cpu {a}, card {b}); CPU top-2 gap "
                        f"{float(top2[0] - top2[1]):.3e}")


def _map(tree, fn):
    return {k: _map(v, fn) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    """A CUDA tensor never falls back to the plain version: an input the
    kernel does not take raises."""
    dev = cuda_device
    x = torch.randn(4, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(x, torch.ones(64, device=dev, dtype=torch.float16))
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(torch.randn(4, 64, device=dev).t(), torch.ones(4, device=dev))
    pk = torch.zeros(4, 1, 16, 8, device=dev)
    with pytest.raises(ValueError):                          # more tokens than the row has pages
        pa_ops.paged_prefill_write(pk, pk.clone(), torch.zeros(1, 40, 1, 8, device=dev),
                                   torch.zeros(1, 40, 1, 8, device=dev),
                                   torch.tensor([1, 2], dtype=torch.int32, device=dev))
    with pytest.raises(ValueError):                          # hd past the kernel's limit
        q = torch.zeros(1, 2, 8, 256, device=dev)
        fa_ops.flash_attention_bhsd(q, q, q)
