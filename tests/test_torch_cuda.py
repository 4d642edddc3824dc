"""The port's CUDA kernels against their plain PyTorch versions, through the
``ops.py`` wrappers, and the paged engine on the card against the engine on
the CPU. These tests carry the ``cuda`` marker and skip where there is no
card; on a machine with one run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch only, so it runs on a machine without JAX. One test
runs everywhere: on a CPU tensor a wrapper takes its plain version and
neither builds nor counts a kernel launch."""
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref,
    paged_prefill_write_quant_ref,
    paged_prefill_write_ref,
)
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}      # tests/test_kernels.py:17
WRAPPERS = (rms_ops.rmsnorm, pa_ops.paged_prefill_write, pa_ops.paged_prefill_write_quant,
            pa_ops.paged_attention, fa_ops.flash_attention_bhsd, da_ops.decode_attention)


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
    qk, qv = torch.zeros(4, 1, 2, 8, dtype=torch.int8), torch.zeros(4, 1, 2, 8, dtype=torch.int8)
    sk, sv = torch.zeros(4, 1, 2, 1, dtype=torch.bfloat16), torch.zeros(4, 1, 2, 1, dtype=torch.bfloat16)
    pa_ops.paged_prefill_write_quant(qk, qv, sk, sv, k, k, torch.tensor([2, 3], dtype=torch.int32))
    assert qk[2].abs().amax() == 127 and sk[2].float().gt(0).all()
    kc = torch.randn(2, 6, 1, 8, generator=g)
    out = da_ops.decode_attention(q[:, :1, :1].reshape(1, 1, 1, 8).expand(2, 1, 1, 8), kc, kc, 4)
    assert out.shape == (2, 1, 1, 8)
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
def test_cuda_decode_attention_matches_plain_version(cuda_device):
    """The dense decode kernel at the launcher's widths: T = 96 (no multiple
    of the tile) and 128, lengths 1, 16, 95 and 96 (and 0, which must be
    finite), the cache read as stored through its strides, with a softcap."""
    dev = cuda_device
    g = torch.Generator(dev).manual_seed(2)
    for dt in (torch.float32, torch.bfloat16):
        for T, cap in ((96, 0.0), (128, 0.0), (96, 30.0)):
            q = torch.randn(5, 1, 15, 64, generator=g, device=dev).to(dt)
            cache = torch.randn(2, 5, T, 5, 64, generator=g, device=dev).to(dt)
            k, v = cache[0], cache[1]                    # views of one stacked tensor
            lens = torch.tensor([1, 16, 95, 96, 0], dtype=torch.int32, device=dev)
            out = da_ops.decode_attention(q, k, v, lens, softcap=cap)
            ref = decode_attention_ref(q[:, 0].reshape(5, 5, 3, 64), k.transpose(1, 2),
                                       v.transpose(1, 2), lens, softcap=cap)
            assert torch.isfinite(out.float()).all()
            assert out[4].float().abs().max() == 0                # length 0 -> 0
            err = (out.reshape(5, 5, 3, 64)[:4].float() - ref[:4].float()).abs().max()
            assert err < TOL[dt], (dt, T, cap, float(err))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_paged_int8_and_chained_legs_match_plain_versions(cuda_device):
    """The quantized write's int8 bits against quantize_kv (a difference only
    at a rounding tie, by 1), untouched pages kept; the int8, chained and
    int8 + chained decode legs against their plain versions, with a dead
    slot and page-boundary lengths; chained bit for bit equal to flat."""
    dev = cuda_device
    g = torch.Generator(dev).manual_seed(3)
    NP, KV, ps, hd = 12, 5, 16, 64
    for dt in (torch.float32, torch.bfloat16):
        k = torch.randn(1, 40, KV, hd, generator=g, device=dev).to(dt)
        v = torch.randn(1, 40, KV, hd, generator=g, device=dev).to(dt)
        pools = [torch.randint(-127, 128, (NP, KV, ps, hd), generator=g, device=dev).to(torch.int8)
                 for _ in range(2)]
        scales = [torch.rand(NP, KV, ps, 1, generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2)]
        row = torch.tensor([3, 8, 1, 0], dtype=torch.int32, device=dev)
        got = pa_ops.paged_prefill_write_quant(*(t.clone() for t in pools + scales), k, v, row)
        want = paged_prefill_write_quant_ref(*(t.clone() for t in pools + scales), k, v, row)
        t = torch.arange(40, device=dev)
        at = (row.long()[t // ps][:, None], torch.arange(KV, device=dev)[None, :], (t % ps)[:, None])
        for x, a, b in ((k, got[0], want[0]), (v, got[1], want[1])):
            xd = x[0].double()          # x * 127 / amax is exact in f64: ties are exact halves
            r = xd * 127 / xd.abs().amax(-1, keepdim=True)
            tie = (r - torch.floor(r)) == 0.5
            d = (a[at].float() - b[at].float()).abs()
            assert d.max() <= 1 and not bool((d > 0)[~tie].any())
            b[at] = a[at]
        for a, b, before in zip(got, want, pools + scales):
            assert torch.equal(a[1:], b[1:])
            assert torch.equal(a[2], before[2]) and torch.equal(a[4:8], before[4:8])
    pk, pv = pools
    ks, vs = scales
    q = torch.randn(4, 1, 15, 64, generator=g, device=dev).to(torch.bfloat16)
    tab = torch.tensor([[0, 0, 0, 0], [1, 2, 3, 0], [4, 5, 6, 7], [9, 10, 11, 1]],
                       dtype=torch.int32, device=dev)
    lens = torch.tensor([1, 16, 49, 64], dtype=torch.int32, device=dev)
    l2 = torch.tensor([[0, 0], [1, 2], [3, 0], [4, 5], [6, 7], [9, 10], [11, 1]],
                      dtype=torch.int32, device=dev)
    l1 = torch.tensor([[0, 0], [1, 2], [3, 4], [5, 6]], dtype=torch.int32, device=dev)
    qg = q[:, 0].reshape(4, 5, 3, 64)
    pf = torch.randn(NP, KV, ps, hd, generator=g, device=dev).to(torch.bfloat16)
    flat_bf = pa_ops.paged_attention(q, pf, pf, tab, lens)
    chain_bf = pa_ops.paged_attention(q, pf, pf, l1, lens, l2_tab=l2)
    assert torch.equal(flat_bf, chain_bf)
    flat = pa_ops.paged_attention(q, pk, pv, tab, lens, pool_ks=ks, pool_vs=vs)
    chain = pa_ops.paged_attention(q, pk, pv, l1, lens, pool_ks=ks, pool_vs=vs, l2_tab=l2)
    assert torch.equal(flat, chain)
    ref = paged_attention_ref(qg, pk, pv, tab, lens, pool_ks=ks, pool_vs=vs)
    assert (flat.reshape(4, 5, 3, 64).float() - ref.float()).abs().max() < TOL[torch.bfloat16]
    assert torch.isfinite(flat.float()).all()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_dense_engine_matches_cpu_engine(cuda_device):
    """The dense engine on the card (the decode and flash kernels) and on the
    CPU, smollm-360m SMOKE in f32 on the same weights, whole-prompt and
    chunked prefill: identical greedy streams."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    cfg = get_config("smollm-360m", smoke=True).replace(attn_chunk=64)
    cpu_params = get_model(cfg).init(torch.Generator().manual_seed(0))
    gpu_params = _map(cpu_params, lambda t: t.to(cuda_device))
    g = torch.Generator().manual_seed(4)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist() for n in (5, 19, 30, 8)]
    for chunk in (0, 16):
        kw = dict(max_slots=3, max_len=64, max_new_tokens=6, chunk_tokens=chunk)
        want = [s.out for s in InferenceEngine(cfg, EngineConfig(**kw), params=cpu_params,
                                               device="cpu").generate(prompts)]
        got = [s.out for s in InferenceEngine(cfg, EngineConfig(**kw), params=gpu_params,
                                              device=cuda_device).generate(prompts)]
        assert got == want, (chunk, want, got)


@pytest.mark.cuda
def test_cuda_chained_and_flat_int8_paged_engines_match(cuda_device):
    """An int8 pool served through chained and through flat tables on the
    card gives identical greedy streams (the chained leg reads the same
    pages in the same order)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine

    cfg = get_config("smollm-360m", smoke=True).replace(attn_chunk=64)
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist() for n in (50, 19, 70)]
    streams = []
    params = None
    for chained in (False, True):
        eng = PagedInferenceEngine(cfg, PagedEngineConfig(
            page_size=8, num_pages=41, max_slots=3, max_seq_len=96, max_new_tokens=6,
            cache_dtype="int8", chained_tables=chained, table_page_entries=4),
            params=params, device=cuda_device)
        params = eng.params
        streams.append([s.out for s in eng.generate(prompts)])
    assert streams[0] == streams[1]


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


def _write_case(dev, g, dt, quant, Lp, hd, shift, aligned=True):
    """One write of Lp tokens (KV 5, 16-token pages) at offset shift * 16
    through a row of ceil(Lp / 16) + 3 entries that holds a null entry and
    two ids outside the pool, against the plain write on the same pools:
    pages 1.. equal (int8 values within one, and only as many as the input
    has rounding ties; scales exact), pages the chunk does not reach
    untouched, two calls bit-identical."""
    KV, ps = 5, 16
    P = -(-Lp // ps) + 3
    NP = P + 2
    row = torch.randperm(NP - 1, generator=torch.Generator().manual_seed(Lp + hd))[:P] + 1
    row[1 % P], row[-1] = -3, NP + 5                # dropped: outside the pool
    row[-2] = 0                                     # the null page
    row = row.to(torch.int32).to(dev)

    def act():
        x = torch.randn(Lp * KV * hd + 1, generator=g, device=dev).to(dt)
        return (x[1:] if not aligned else x[:-1]).view(1, Lp, KV, hd)

    k, v = act(), act()
    if quant:
        pools = [torch.randint(-127, 128, (NP, KV, ps, hd), generator=g, device=dev).to(torch.int8)
                 for _ in range(2)]
        pools += [torch.rand(NP, KV, ps, 1, generator=g, device=dev).to(torch.bfloat16) for _ in range(2)]
        kernel, plain = pa_ops.paged_prefill_write_quant, paged_prefill_write_quant_ref
    else:
        pools = [torch.randn(NP, KV, ps, hd, generator=g, device=dev).to(dt) for _ in range(2)]
        kernel, plain = pa_ops.paged_prefill_write, paged_prefill_write_ref
    got = kernel(*(p.clone() for p in pools), k, v, row, offset=shift * ps)
    again = kernel(*(p.clone() for p in pools), k, v, row, offset=shift * ps)
    want = plain(*(p.clone() for p in pools), k, v, pa_ops._shift_row(row, shift * ps, ps))
    torch.cuda.synchronize()
    ids = pa_ops.write_page_ids(row, shift, Lp, ps).long()
    untouched = torch.ones(NP, dtype=torch.bool, device=dev)
    untouched[ids[(ids >= 0) & (ids < NP)]] = False
    untouched[0] = False
    ties = 0
    if quant:
        for x in (k, v):
            xd = x.double()
            r = xd * 127 / xd.abs().amax(-1, keepdim=True).clamp_min(1e-300)
            ties += int(((r - torch.floor(r)) == 0.5).sum())
    case = f"{'quant' if quant else 'write'} {dt} Lp {Lp} hd {hd} shift {shift} aligned {aligned}"
    for a, b, c, before in zip(got, want, again, pools):
        assert torch.equal(a[1:], c[1:]), case
        if a.dtype == torch.int8:
            d = (a[1:].int() - b[1:].int()).abs()
            assert int(d.max()) <= 1 and int((d > 0).sum()) <= ties, case
        else:
            assert torch.equal(a[1:], b[1:]), case
        assert torch.equal(a[untouched], before[untouched]), case


@pytest.mark.cuda
def test_cuda_paged_writes_match_plain_versions(cuda_device):
    """Both writes at Lp 1, 16, 20, 256 and 2048, f32 and bf16, hd 20, 64
    and 128, at offsets 0, one and two pages, on the row's last entry and
    wholly past the row's end; unaligned k/v (the narrow unit paths and the
    quantizing write's general path) at hd 64."""
    dev = cuda_device
    g = torch.Generator(dev).manual_seed(11)
    for quant in (False, True):
        for dt in (torch.float32, torch.bfloat16):
            for hd in (20, 64, 128):
                for Lp in (1, 16, 20, 256, 2048):
                    P = -(-Lp // 16) + 3
                    for shift in (0, 1, 2, P - 1, P + 1):
                        _write_case(dev, g, dt, quant, Lp, hd, shift)
            for Lp in (16, 20, 256):
                _write_case(dev, g, dt, quant, Lp, 64, 1, aligned=False)


@pytest.mark.cuda
def test_cuda_chunked_write_is_one_launch_and_one_device_operation(cuda_device):
    """A write with an offset is one device operation, the kernel, and
    counts one launch: the chunk's shift is resolved inside the kernel. Ten
    calls are profiled, as the profiler may drop an event (never add one)."""
    from torch.autograd import DeviceType

    dev = cuda_device
    pk, pv = torch.zeros(9, 5, 16, 64, device=dev), torch.zeros(9, 5, 16, 64, device=dev)
    qk, qv = torch.zeros_like(pk, dtype=torch.int8), torch.zeros_like(pv, dtype=torch.int8)
    qs = [torch.zeros(9, 5, 16, 1, device=dev, dtype=torch.bfloat16) for _ in range(2)]
    k = torch.randn(1, 16, 5, 64, device=dev)
    row = torch.tensor([3, 8, 1, 0, 5, 2], dtype=torch.int32, device=dev)
    calls = {pa_ops.paged_prefill_write: lambda: pa_ops.paged_prefill_write(pk, pv, k, k, row, offset=32),
             pa_ops.paged_prefill_write_quant:
                 lambda: pa_ops.paged_prefill_write_quant(qk, qv, *qs, k, k, row, offset=32)}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for wrapper, call in calls.items():
        call()
        torch.cuda.synchronize()
        before = wrapper.launches
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        ops = sum(e.count for e in prof.key_averages() if e.device_type != DeviceType.CPU)
        assert round(ops / 10) == 1, (wrapper.__name__, [e.key for e in prof.key_averages()])
        assert wrapper.launches == before + 10


def _mlstm_inputs(g, dev, BH, S, DH, dt):
    """q (scaled by DH^-1/2 as the model scales it), k, v in ``dt``; i and
    lf = log_sigmoid(f) in f32."""
    q = (torch.randn(BH, S, DH, generator=g, device=dev) * DH ** -0.5).to(dt)
    k = torch.randn(BH, S, DH, generator=g, device=dev).to(dt)
    v = torch.randn(BH, S, DH, generator=g, device=dev).to(dt)
    i = torch.randn(BH, S, generator=g, device=dev)
    lf = torch.nn.functional.logsigmoid(torch.randn(BH, S, generator=g, device=dev) + 2.0)
    return q, k, v, i, lf


def _scaled_err(a, b) -> float:
    """Largest difference, over the reference's largest magnitude where that
    is above 1."""
    b = b.float()
    return float((a.float() - b).abs().max()) / max(1.0, float(b.abs().max()))


@pytest.mark.cuda
def test_cuda_mlstm_chunkwise_matches_plain_version(cuda_device):
    """The chunkwise mLSTM kernel at xlstm-350m FULL's head width (DH = 512)
    for one and four sequences of 4 heads, every chunk length the serving
    paths give it (S 8, 32, 96, L = S; S 256, L = 64; a ragged S 200, L =
    S), bf16 and f32, from zero and from a non-zero carry; then a tail of
    all-pad chunks leaves (C, n, m) bit-identical."""
    from repro_torch.kernels.mlstm_chunk import ops as mk_ops
    from repro_torch.kernels.mlstm_chunk.ref import NEG, mlstm_chunkwise_bh_ref

    dev = cuda_device
    g = torch.Generator(dev).manual_seed(6)
    DH = 512
    for BH in (4, 16):
        zero = (torch.zeros(BH, DH, DH, device=dev), torch.zeros(BH, DH, device=dev),
                torch.zeros(BH, device=dev))
        pre = _mlstm_inputs(g, dev, BH, 24, DH, torch.float32)
        carried = mlstm_chunkwise_bh_ref(*pre, *zero, chunk=64)[1:]
        for dt in (torch.float32, torch.bfloat16):
            for S in (8, 32, 96, 256, 200):
                x = _mlstm_inputs(g, dev, BH, S, DH, dt)
                for carry in (zero, carried):
                    got = mk_ops.mlstm_chunkwise_bh(*x, *carry, chunk=64)
                    want = mlstm_chunkwise_bh_ref(*x, *carry, chunk=64)
                    assert got[0].dtype == dt and got[0].shape == (BH, S, DH)
                    assert torch.isfinite(got[0].float()).all()
                    tol = TOL[dt]
                    assert _scaled_err(got[0], want[0]) < tol, (BH, S, dt, "h")
                    for name, a, b in zip("Cnm", got[1:], want[1:]):
                        e = _scaled_err(a, b) if name == "m" else \
                            float((a - b).abs().max()) / float(b.abs().max())
                        assert e < TOL[torch.float32], (BH, S, dt, name, e)
    x = _mlstm_inputs(g, dev, 4, 64, DH, torch.bfloat16)
    i = x[3].clone()
    lf = x[4].clone()
    i[:, 32:] = NEG
    lf[:, 32:] = 0.0
    carry = [t[:4].contiguous() for t in carried]
    padded = mk_ops.mlstm_chunkwise_bh(*x[:3], i, lf, *carry, chunk=32)
    head = mk_ops.mlstm_chunkwise_bh(*(t[:, :32].contiguous() for t in (*x[:3], i, lf)), *carry,
                                     chunk=32)
    for a, b in zip(padded[1:], head[1:]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):                          # DH not a multiple of 32
        q = torch.zeros(1, 8, 48, device=dev)
        mk_ops.mlstm_chunkwise_bh(q, q, q, q[..., 0], q[..., 0], torch.zeros(1, 48, 48, device=dev),
                                  torch.zeros(1, 48, device=dev), torch.zeros(1, device=dev))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_mlstm_bf16_tile_plan_and_chunk_lengths(cuda_device):
    """The bf16 tensor-core instance across its column-tile plan (BH 1, 4,
    8, 16, 33 at DH 512; DH 32, 64 and 1024, at TC 16 and 32) and chunk
    lengths L 1, 8, 17, 64 and a ragged 200, from zero and from a carried
    state, against the plain version at the tolerances above (h 2e-2, C/n/m
    2e-5); two calls on the same inputs are bit-identical, one launch each."""
    from repro_torch.kernels.mlstm_chunk import ops as mk_ops
    from repro_torch.kernels.mlstm_chunk.ref import chunk_len, mlstm_chunkwise_bh_ref

    dev = cuda_device
    g = torch.Generator(dev).manual_seed(8)
    bf16 = torch.bfloat16
    plans = {(1, 512): 16, (4, 512): 16, (8, 512): 16, (16, 512): 32, (33, 512): 32,
             (4, 32): 16, (4, 64): 16, (4, 1024): 16, (8, 1024): 32}
    lengths = ((3, 1), (16, 8), (34, 17), (128, 64), (200, 64))     # (S, chunk): L 1 to 200
    for (BH, DH), tc in plans.items():
        assert mk_ops.plan_col_tile(BH, DH) == tc
        zero = (torch.zeros(BH, DH, DH, device=dev), torch.zeros(BH, DH, device=dev),
                torch.zeros(BH, device=dev))
        carried = mlstm_chunkwise_bh_ref(*_mlstm_inputs(g, dev, BH, 24, DH, torch.float32), *zero,
                                         chunk=64)[1:]
        for S, chunk in lengths:
            x = _mlstm_inputs(g, dev, BH, S, DH, bf16)
            for carry in (zero, carried):
                before = mk_ops.mlstm_chunkwise_bh.launches
                got = mk_ops.mlstm_chunkwise_bh(*x, *carry, chunk=chunk)
                again = mk_ops.mlstm_chunkwise_bh(*x, *carry, chunk=chunk)
                want = mlstm_chunkwise_bh_ref(*x, *carry, chunk=chunk)
                case = (BH, DH, tc, S, chunk_len(S, chunk))
                assert mk_ops.mlstm_chunkwise_bh.launches == before + 2, case
                assert all(torch.equal(a, b) for a, b in zip(got, again)), case
                assert got[0].dtype == bf16 and torch.isfinite(got[0].float()).all(), case
                assert _scaled_err(got[0], want[0]) < TOL[bf16], (case, "h")
                for name, a, b in zip("Cnm", got[1:], want[1:]):
                    e = _scaled_err(a, b) if name == "m" else \
                        float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                    assert e < TOL[torch.float32], (case, name, e)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_tokens", [0, 16], ids=["whole_prompt", "chunked"])
def test_cuda_xlstm_engine_matches_cpu_engine(cuda_device, chunk_tokens):
    """The paged engine serving xlstm-350m SMOKE in f32 on the card (the
    mLSTM and rmsnorm kernels) and on the CPU, on the same weights:
    identical greedy streams, prompts across chunks so the carry crosses
    calls."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.mlstm_chunk import ops as mk_ops
    from repro_torch.models import get_model
    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine

    cfg = get_config("xlstm-350m", smoke=True)
    cpu_params = get_model(cfg).init(torch.Generator().manual_seed(0))
    gpu_params = _map(cpu_params, lambda t: t.to(cuda_device))
    kw = dict(page_size=8, num_pages=33, max_slots=3, max_seq_len=64, max_new_tokens=6,
              chunk_tokens=chunk_tokens)
    g = torch.Generator().manual_seed(7)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist() for n in (5, 19, 30, 8)]
    want = [s.out for s in PagedInferenceEngine(cfg, PagedEngineConfig(**kw), params=cpu_params,
                                                device="cpu").generate(prompts)]
    before = mk_ops.mlstm_chunkwise_bh.launches
    got = [s.out for s in PagedInferenceEngine(cfg, PagedEngineConfig(**kw), params=gpu_params,
                                               device=cuda_device).generate(prompts)]
    assert mk_ops.mlstm_chunkwise_bh.launches > before
    assert got == want, (want, got)


def _decode_case(dev, g, dt, B, T, lens, cap=0.0):
    """decode_attention over a (B, T, 5, 64) cache stacked with its twin (so
    k and v are strided views), against the plain version; returns (out,
    error over the rows of nonzero length)."""
    q = torch.randn(B, 1, 15, 64, generator=g, device=dev).to(dt)
    cache = torch.randn(2, B, T, 5, 64, generator=g, device=dev).to(dt)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = da_ops.decode_attention(q, cache[0], cache[1], lens, softcap=cap)
    ref = decode_attention_ref(q[:, 0].reshape(B, 5, 3, 64), cache[0].transpose(1, 2),
                               cache[1].transpose(1, 2), lens, softcap=cap)
    assert torch.isfinite(out.float()).all()
    live = lens > 0
    if bool((~live).any()):
        assert out[~live].float().abs().max() == 0                  # length 0 -> 0
    if not bool(live.any()):
        return q, cache, lens, out, 0.0
    err = (out.reshape(B, 5, 3, 64)[live].float() - ref[live].float()).abs().max()
    return q, cache, lens, out, float(err)


@pytest.mark.cuda
def test_cuda_decode_attention_split_boundaries(cuda_device):
    """The dense decode kernel where the T axis is split across blocks:
    lengths 0, 1, split - 1, split, split + 1 and T at T = 4096 (B = 6 and
    4), every length of a B = 1 cache of 4096, a T that is no multiple of 32,
    f32 and bf16, with and without the softcap; two calls are bit-identical
    (the splits are combined in a fixed order)."""
    dev = cuda_device
    g = torch.Generator(dev).manual_seed(8)
    for dt in (torch.float32, torch.bfloat16):
        for B, T, cap in ((6, 4096, 0.0), (4, 4096, 30.0), (6, 1000, 0.0)):
            n = da_ops.plan_splits(B, 5, T)
            assert n > 1
            s = da_ops.split_bounds(T, n)[1][0]
            lens = [0, 1, s - 1, s, s + 1, T][:B] if B == 6 else [s - 1, s + 1, T, 0]
            q, cache, lens_t, out, err = _decode_case(dev, g, dt, B, T, lens, cap)
            assert err < TOL[dt], (dt, B, T, cap, lens, err)
            again = da_ops.decode_attention(q, cache[0], cache[1], lens_t, softcap=cap)
            assert torch.equal(out, again)
        n = da_ops.plan_splits(1, 5, 4096)
        bounds = da_ops.split_bounds(4096, n)
        for L in (0, 1, bounds[0][1] - 1, bounds[0][1], bounds[0][1] + 1, 2049, 4096):
            err = _decode_case(dev, g, dt, 1, 4096, [L])[4]
            assert err < TOL[dt], (dt, L, err)
    torch.cuda.synchronize()


def _flash_inputs(g, dev, dt, B, S, KV, G, hd):
    """q, k, v in the model's strided layout: views of one fused
    (B, S, H + 2 KV, hd) projection, as a fused QKV matmul would leave them."""
    H = G * KV
    qkv = torch.randn(B, S, H + 2 * KV, hd, generator=g, device=dev).to(dt)
    return qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]


@pytest.mark.cuda
def test_cuda_flash_attention_layouts_match_plain_version(cuda_device):
    """The flash kernel, bf16 (tensor cores) and f32 (CUDA cores), at S 2 to
    2048 (ragged S, one and many kv tiles), G 1, 3, 4 and 8, hd 64, 80 and
    128 (and 20: the plain-load path), on the model's strided (B, S, H, hd)
    views and on (B, H, S, hd) tensors, against attention_ref; one call is
    one device operation (no copy of q, k or v) and its output contiguous."""
    from torch.autograd import DeviceType

    dev = cuda_device
    g = torch.Generator(dev).manual_seed(11)
    KV = 2
    for dt in (torch.bfloat16, torch.float32):
        for S in (2, 16, 17, 40, 96, 128, 200, 2048):
            for G in (1, 3, 4, 8):
                for hd in (64, 80, 128, 20):
                    B = 1 if S == 2048 else 2
                    q, k, v = _flash_inputs(g, dev, dt, B, S, KV, G, hd)
                    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2)).transpose(1, 2)
                    out = fa_ops.flash_attention(q, k, v)
                    assert out.is_contiguous() and out.shape == q.shape
                    err = float((out.float() - want.float()).abs().max())
                    assert err < TOL[dt], (dt, S, G, hd, "bshd", err)
                    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                    out_h = fa_ops.flash_attention_bhsd(qh, kh, vh)
                    err = float((out_h.float() - want.transpose(1, 2).float()).abs().max())
                    assert err < TOL[dt], (dt, S, G, hd, "bhsd", err)
    q, k, v = _flash_inputs(g, dev, torch.bfloat16, 1, 16, 5, 3, 64)
    fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fa_ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
    ops = sum(e.count for e in prof.key_averages() if e.device_type != DeviceType.CPU)
    assert ops in (0, 1), ops                    # 0: the profiler saw no device activity
    torch.cuda.synchronize()


def _paged_setup(g, gen_tab, dev, B, KV, hd, ps, P, lens, dt, quant):
    """A pool holding each row's live pages (distinct, in random order), its
    flat table (dead rows on the null page 0) and chained tables encoding it
    (4 entries a table page)."""
    need = [-(-L // ps) for L in lens]
    NP = 1 + sum(need)
    perm = (torch.randperm(NP - 1, generator=gen_tab) + 1).tolist()
    tab = torch.zeros(B, P, dtype=torch.int32)
    for b, n in enumerate(need):
        tab[b, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    tpp = 4
    W1 = P // tpp
    l1 = torch.zeros(B, W1, dtype=torch.int32)
    rows = [torch.zeros(tpp, dtype=torch.int32)]
    for b in range(B):
        for j in range(W1):
            piece = tab[b, j * tpp:(j + 1) * tpp]
            if bool(piece.ne(0).any()):
                l1[b, j] = len(rows)
                rows.append(piece)
    l2 = torch.stack(rows)
    if quant:
        pools = [torch.randint(-127, 128, (NP, KV, ps, hd), generator=g, device=dev).to(torch.int8)
                 for _ in range(2)]
        kw = {"pool_ks": (torch.rand(NP, KV, ps, 1, generator=g, device=dev) * 0.05).to(torch.bfloat16),
              "pool_vs": (torch.rand(NP, KV, ps, 1, generator=g, device=dev) * 0.05).to(torch.bfloat16)}
    else:
        pools = [torch.randn(NP, KV, ps, hd, generator=g, device=dev).to(dt) for _ in range(2)]
        kw = {}
    return pools, kw, tab.to(dev), l1.to(dev), l2.to(dev)


@pytest.mark.cuda
def test_cuda_paged_decode_split_boundaries(cuda_device):
    """The paged decode where a row's pages are split across blocks, on
    every leg (flat and chained tables, f32, bf16 and int8 pools, with and
    without the softcap), G 3, 4 and 8: lengths 0, 1 (a dead slot on the
    null page), split - 1, split, split + 1 and a full row, then the
    neighbours of three split boundaries and a full row at B = 1; against
    paged_attention_ref, two
    calls bit-identical, chained bit-identical to flat, a length of 0 gives
    0, a dead slot is finite."""
    dev = cuda_device
    g = torch.Generator(dev).manual_seed(12)
    gen_tab = torch.Generator().manual_seed(12)
    KV, hd, ps, P = 2, 64, 16, 64
    for dt, quant in ((torch.bfloat16, False), (torch.float32, False), (torch.bfloat16, True),
                      (torch.float32, True)):
        for G in (3, 4, 8):
            for cap in (0.0, 30.0):
                for B in (6, 1):
                    n = pa_ops.plan_page_splits(B, KV, P, ps)
                    assert n > 1
                    bounds = pa_ops.page_split_bounds(P, n)
                    s = bounds[1][0] * ps
                    cases = ([[0, 1, s - 1, s, s + 1, P * ps]] if B == 6 else
                             [[L] for i in (1, n // 2, n - 1)
                              for L in (bounds[i][0] * ps - 1, bounds[i][0] * ps, bounds[i][0] * ps + 1)]
                             + [[P * ps]])
                    for lens_l in cases:
                        pools, kw, tab, l1, l2 = _paged_setup(g, gen_tab, dev, B, KV, hd, ps, P,
                                                              lens_l, dt, quant)
                        if B == 6:
                            tab[1] = 0                   # dead slot: length 1 over the null page
                            l1[1] = 0
                        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
                        q = torch.randn(B, 1, G * KV, hd, generator=g, device=dev).to(dt)
                        out = pa_ops.paged_attention(q, *pools, tab, lens, softcap=cap, **kw)
                        again = pa_ops.paged_attention(q, *pools, tab, lens, softcap=cap, **kw)
                        chained = pa_ops.paged_attention(q, *pools, l1, lens, softcap=cap, l2_tab=l2, **kw)
                        ref = paged_attention_ref(q[:, 0].reshape(B, KV, G, hd), *pools, tab, lens,
                                                  softcap=cap, **kw)
                        name = (dt, quant, G, cap, lens_l)
                        assert torch.isfinite(out.float()).all(), name
                        assert torch.equal(out, again), name
                        assert torch.equal(out, chained), name
                        live = lens > 0
                        if bool((~live).any()):
                            assert float(out[~live].float().abs().max()) == 0.0, name
                        err = (out.reshape(B, KV, G, hd)[live].float() - ref[live].float()).abs().max()
                        assert float(err) < TOL[dt], (name, float(err))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_rmsnorm_one_warp_and_general_paths(cuda_device):
    """rmsnorm's one-warp path (D = 960 in bf16 and f32, D = 2048 bf16) and
    its general path (D = 997 and 4096, and an unaligned row), rows 1, 8 and
    4096, f32 and bf16."""
    dev = cuda_device
    g = torch.Generator(dev).manual_seed(9)
    for dt in (torch.float32, torch.bfloat16):
        for D in (960, 997, 2048, 4096):
            for R in (1, 8, 4096):
                x = torch.randn(R, D, generator=g, device=dev).to(dt)
                w = torch.linspace(0.5, 1.5, D, device=dev).to(dt)
                err = (rms_ops.rmsnorm(x, w).float() - rmsnorm_ref(x, w).float()).abs().max()
                assert err < TOL[dt], (dt, D, R, float(err))
        buf = torch.randn(8 * 960 + 1, generator=g, device=dev).to(dt)
        x = buf[1:].view(8, 960)                          # contiguous, not 16-byte aligned
        w = torch.linspace(0.5, 1.5, 960, device=dev).to(dt)
        assert (rms_ops.rmsnorm(x, w).float() - rmsnorm_ref(x, w).float()).abs().max() < TOL[dt]
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_kernels_launch_on_the_current_stream(cuda_device):
    """A kernel launched under ``torch.cuda.stream(s)``, and from a second
    thread with a stream of its own, runs on that stream: it reads inputs
    that a copy queued on s behind a device sleep writes, so on any other
    stream it would read zeros."""
    dev = cuda_device
    g = torch.Generator(dev).manual_seed(10)
    x = torch.randn(4096, 960, generator=g, device=dev).to(torch.bfloat16)
    w = torch.linspace(0.5, 1.5, 960, device=dev).to(torch.bfloat16)
    q = torch.randn(4, 1, 15, 64, generator=g, device=dev).to(torch.bfloat16)
    cache = torch.randn(2, 4, 4096, 5, 64, generator=g, device=dev).to(torch.bfloat16)
    lens = torch.tensor([1024, 2048, 3072, 4096], dtype=torch.int32, device=dev)
    want = rmsnorm_ref(x, w)
    want_d = da_ops.decode_attention(q, cache[0], cache[1], lens)
    torch.cuda.synchronize()
    results = {}

    def run(name):
        xs, qs = torch.zeros_like(x), torch.zeros_like(q)
        torch.cuda.synchronize()
        s = torch.cuda.Stream(device=dev)
        with torch.cuda.stream(s):
            torch.cuda._sleep(20_000_000)
            xs.copy_(x)
            qs.copy_(q)
            out = rms_ops.rmsnorm(xs, w)
            out_d = da_ops.decode_attention(qs, cache[0], cache[1], lens)
        s.synchronize()
        results[name] = (out, out_d)

    run("main thread")
    t = threading.Thread(target=run, args=("second thread",))
    t.start()
    t.join()
    assert set(results) == {"main thread", "second thread"}
    for name, (out, out_d) in results.items():
        assert (out.float() - want.float()).abs().max() < TOL[torch.bfloat16], name
        assert torch.equal(out_d, want_d), name


@pytest.mark.cuda
def test_cuda_launch_counts_exact_under_threads(cuda_device):
    """4 threads x 100 calls of two wrappers: every launch is counted once."""
    from repro_torch.kernels import _build

    dev = cuda_device
    x = torch.randn(8, 960, device=dev).to(torch.bfloat16)
    w = torch.ones(960, device=dev).to(torch.bfloat16)
    q = torch.randn(4, 1, 15, 64, device=dev).to(torch.bfloat16)
    cache = torch.randn(2, 4, 96, 5, 64, device=dev).to(torch.bfloat16)
    lens = torch.tensor([1, 9, 57, 96], dtype=torch.int32, device=dev)
    rms_ops.rmsnorm(x, w)
    da_ops.decode_attention(q, cache[0], cache[1], lens)
    _build.reset_launches(rms_ops.rmsnorm)
    _build.reset_launches(da_ops.decode_attention)

    def work():
        for _ in range(100):
            rms_ops.rmsnorm(x, w)
            da_ops.decode_attention(q, cache[0], cache[1], lens)

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert rms_ops.rmsnorm.launches == 400
    assert da_ops.decode_attention.launches == 400
