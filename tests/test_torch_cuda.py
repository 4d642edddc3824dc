"""The port's CUDA kernels against their plain PyTorch versions, through the
``ops.py`` wrappers, the paged engine on the card against the engine on the
CPU, and the vectorized placer on the card against the CPU. These tests carry the ``cuda`` marker and skip where there is no
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
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_cuda_verify_writes_match_the_cpu_call(cuda_device, quant):
    """Both speculative verify writes (plain PyTorch on every device) on
    CUDA tensors against the same call on CPU tensors, at offsets inside a
    page, across pages and past the row's end: bit for bit, the null page
    included except where several tokens collide on it."""
    g = torch.Generator().manual_seed(11)
    NP, KV, ps, hd, S = 9, 5, 16, 64, 5
    tab = torch.tensor([6, 2, 8, 3], dtype=torch.int32)
    for offset in (3, 13, 60, 62, 70):
        k = torch.randn(1, S, KV, hd, generator=g)
        v = torch.randn(1, S, KV, hd, generator=g)
        if quant:
            pools = [torch.randint(-127, 128, (NP, KV, ps, hd), generator=g, dtype=torch.int8)
                     for _ in range(2)]
            pools += [torch.rand(NP, KV, ps, 1, generator=g).bfloat16() for _ in range(2)]
            fn = pa_ops.paged_verify_write_quant
        else:
            pools = [torch.randn(NP, KV, ps, hd, generator=g) for _ in range(2)]
            fn = pa_ops.paged_verify_write
        gpu = [p.to(cuda_device) for p in pools]
        want = fn(*pools, k, v, tab, offset)
        got = fn(*gpu, k.to(cuda_device), v.to(cuda_device), tab.to(cuda_device), offset)
        null_hits = sum((offset + t) // ps >= tab.shape[0] for t in range(S))
        for a, b in zip(want, got):
            lo = 1 if null_hits > 1 else 0
            assert torch.equal(a[lo:], b.cpu()[lo:]), offset


@pytest.mark.cuda
def test_cuda_copy_fork_matches_the_cpu_copy(cuda_device):
    """fork()'s device copy on an int8 smollm pool and an xLSTM slot state:
    the card's copy equals the CPU's bit for bit."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model
    from repro_torch.serving.engine import copy_fork

    g = torch.Generator().manual_seed(12)
    for arch, quant in (("smollm-360m", True), ("xlstm-350m", False)):
        cfg = get_config(arch, smoke=True).replace(kv_quant=quant)
        cache = get_model(cfg).init_paged_cache(9, 8, "cpu", batch=3)
        for leaves in cache["blocks"].values():
            for leaf in leaves.values():
                if leaf.dtype == torch.int8:
                    leaf.copy_(torch.randint(-127, 128, leaf.shape, generator=g, dtype=torch.int8))
                else:
                    leaf.copy_(torch.randn(leaf.shape, generator=g).to(leaf.dtype))
        gpu = _map(cache, lambda t: t.to(cuda_device))
        copy_fork(cfg, cache, [3, 5], [7, 1], 0, 2)
        copy_fork(cfg, gpu, [3, 5], [7, 1], 0, 2)
        for key, leaves in cache["blocks"].items():
            for name, leaf in leaves.items():
                assert torch.equal(leaf, gpu["blocks"][key][name].cpu()), (arch, key, name)


@pytest.mark.cuda
def test_cuda_engine_with_spec_and_prefix_cache_matches_cpu_engine(cuda_device):
    """The paged engine on the card with speculation and the prefix cache on
    (verify passes, prefix hits at a page offset, an int8 pool) against the
    same engine on the CPU, smollm-360m SMOKE in f32 at a 24-token
    vocabulary on the same weights: identical greedy streams, proposals
    accepted, prefixes hit; a flip reports the CPU's top-2 logit gap."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model
    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine

    cfg = get_config("smollm-360m", smoke=True).replace(attn_chunk=64, vocab_size=24)
    model = get_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    gpu_params = _map(cpu_params, lambda t: t.to(cuda_device))
    system = [(3 * i) % 23 + 1 for i in range(20)]
    prompts = [system + [1, 2, 3, 1, 2, 3], system + [7, 8, 9, 7, 8], system + [5, 5, 6]]
    for extra in ({}, {"cache_dtype": "int8"}, {"chunk_tokens": 16}):
        kw = dict(page_size=8, num_pages=65, max_slots=3, max_seq_len=96, max_new_tokens=24,
                  spec_tokens=4, prefix_cache=True, **extra)
        runs = []
        for params, dev in ((cpu_params, "cpu"), (gpu_params, cuda_device)):
            eng = PagedInferenceEngine(cfg, PagedEngineConfig(**kw), params=params, device=dev)
            outs = [s.out for s in eng.generate(prompts)] + [s.out for s in eng.generate(prompts)]
            assert eng.spec_accepted > 0 and eng.capacity_now()["prefix_cached_tokens"] > 0
            eng.allocator.check_invariants()
            runs.append(outs)
        for prompt, a, b in zip(prompts * 2, *runs):
            if a != b:
                j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
                with torch.no_grad():
                    row = model.logits(cpu_params, model.hidden(cpu_params, [prompt + a[:j]]))[0, -1]
                top2 = torch.topk(row, 2).values
                pytest.fail(f"{extra}: token {j} differs (cpu {a}, card {b}); CPU top-2 gap "
                            f"{float(top2[0] - top2[1]):.3e}")


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


ANY_G = (1, 3, 5, 8, 9, 12, 16, 24)


@pytest.mark.cuda
def test_cuda_paged_decode_any_G(cuda_device):
    """The paged decode at G 1, 3, 5, 8, 9, 12, 16 and 24 (past 8: head
    groups of 4 as blocks), hd 64 and 128, f32 and bf16 queries over pools
    of their dtype or int8, flat and chained tables, with and without the
    softcap (the softcap on the bf16 pools): lengths 0, 1 (a dead
    slot), split - 1, split, split + 1 and a full row at the planner's
    splits, then one split; against paged_attention_ref, two calls
    bit-identical, chained bit-identical to flat, one launch a call, a
    length of 0 gives 0. Then qwen1.5-32b's shape, G = 1 over 40 KV heads at
    hd 128, and glm4-9b's, G = 16 over 2."""
    dev = cuda_device
    g = torch.Generator(dev).manual_seed(20)
    gen_tab = torch.Generator().manual_seed(20)
    ps, P = 16, 64
    cases = [(G, 2, hd, 6) for G in ANY_G for hd in (64, 128)] + [(1, 40, 128, 8), (16, 2, 128, 8)]
    for G, KV, hd, B in cases:
        for dt, quant in ((torch.bfloat16, False), (torch.float32, False), (torch.bfloat16, True),
                          (torch.float32, True)):
            n = pa_ops.plan_page_splits(B, KV, P, ps, G)
            s = pa_ops.page_split_bounds(P, n)[1][0] * ps if n > 1 else 200
            lens_l = ([0, 1, s - 1, s, s + 1, P * ps] if B == 6 else
                      [120, 128, 129, 144, 161, 176, 193, 208])     # the pools phase's lengths
            pools, kw, tab, l1, l2 = _paged_setup(g, gen_tab, dev, B, KV, hd, ps, P, lens_l, dt, quant)
            if B == 6:
                tab[1] = 0                              # dead slot: length 1 over the null page
                l1[1] = 0
            lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
            q = torch.randn(B, 1, G * KV, hd, generator=g, device=dev).to(dt)
            cap = 30.0 if dt == torch.bfloat16 and not quant else 0.0
            before = pa_ops.paged_attention.launches
            out = pa_ops.paged_attention(q, *pools, tab, lens, softcap=cap, **kw)
            assert pa_ops.paged_attention.launches == before + 1
            again = pa_ops.paged_attention(q, *pools, tab, lens, softcap=cap, **kw)
            chained = pa_ops.paged_attention(q, *pools, l1, lens, softcap=cap, l2_tab=l2, **kw)
            ref = paged_attention_ref(q[:, 0].reshape(B, KV, G, hd), *pools, tab, lens, softcap=cap,
                                      **kw)
            name = (G, KV, hd, dt, quant, cap, n, lens_l)
            assert torch.isfinite(out.float()).all(), name
            assert torch.equal(out, again) and torch.equal(out, chained), name
            live = lens > 0
            if bool((~live).any()):
                assert float(out[~live].float().abs().max()) == 0.0, name
            err = (out.reshape(B, KV, G, hd)[live].float() - ref[live].float()).abs().max()
            assert float(err) < TOL[dt], (name, float(err))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_decode_attention_any_G(cuda_device):
    """The dense decode at G 1, 3, 5, 8, 9, 12, 16 and 24, hd 64 and 128,
    f32 and bf16, with and without the softcap: a T split across blocks
    (lengths 0, 1, split - 1, split, split + 1 and T at T = 1000) and the
    launcher's one-split cache (T = 96); against the plain version, two calls
    bit-identical, one launch a call, a length of 0 gives 0. Then
    qwen1.5-32b's shape (G = 1 over 40 KV heads, hd 128) and glm4-9b's
    (G = 16 over 2) at the launcher's cache."""
    dev = cuda_device
    g = torch.Generator(dev).manual_seed(21)
    cases = [(G, 2, hd) for G in ANY_G for hd in (64, 128)] + [(1, 40, 128), (16, 2, 128)]
    for G, KV, hd in cases:
        for dt in (torch.bfloat16, torch.float32):
            for B, T, cap in ((6, 1000, 0.0), (6, 1000, 30.0), (4, 96, 0.0)):
                n = da_ops.plan_splits(B, KV, T, G)
                s = da_ops.split_bounds(T, n)[1][0] if n > 1 else 57
                lens_l = [0, 1, s - 1, s, s + 1, T][:B] if B == 6 else [1, 9, 57, 96]
                q = torch.randn(B, 1, G * KV, hd, generator=g, device=dev).to(dt)
                cache = torch.randn(2, B, T, KV, hd, generator=g, device=dev).to(dt)
                lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
                before = da_ops.decode_attention.launches
                out = da_ops.decode_attention(q, cache[0], cache[1], lens, softcap=cap)
                assert da_ops.decode_attention.launches == before + 1
                again = da_ops.decode_attention(q, cache[0], cache[1], lens, softcap=cap)
                ref = decode_attention_ref(q[:, 0].reshape(B, KV, G, hd), cache[0].transpose(1, 2),
                                           cache[1].transpose(1, 2), lens, softcap=cap)
                name = (G, KV, hd, dt, B, T, cap, n)
                assert torch.isfinite(out.float()).all(), name
                assert torch.equal(out, again), name
                live = lens > 0
                if bool((~live).any()):
                    assert float(out[~live].float().abs().max()) == 0.0, name
                err = (out.reshape(B, KV, G, hd)[live].float() - ref[live].float()).abs().max()
                assert float(err) < TOL[dt], (name, float(err))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_flash_attention_G16(cuda_device):
    """Flash at glm4-9b's grouping, G = 16 over 2 KV heads at hd 128 (a row
    tile of 4 positions x 16 heads), S 2 to 2048, bf16 and f32, on the
    model's strided (B, S, H, hd) views and on (B, H, S, hd) tensors."""
    dev = cuda_device
    g = torch.Generator(dev).manual_seed(22)
    for dt in (torch.bfloat16, torch.float32):
        for S in (2, 16, 17, 40, 96, 200, 2048):
            B = 1 if S == 2048 else 2
            q, k, v = _flash_inputs(g, dev, dt, B, S, 2, 16, 128)
            want = attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
            out = fa_ops.flash_attention(q, k, v)
            assert out.is_contiguous() and out.shape == q.shape
            err = float((out.float() - want.float()).abs().max())
            assert err < TOL[dt], (dt, S, "bshd", err)
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            err = float((fa_ops.flash_attention_bhsd(qh, kh, vh).float()
                         - want.transpose(1, 2).float()).abs().max())
            assert err < TOL[dt], (dt, S, "bhsd", err)
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


@pytest.mark.cuda
def test_cuda_placing_batch_matches_cpu_at_7000(cuda_device):
    """The vectorized placer on the card against the CPU at the paper's top
    ramp (7000 bimodal sessions a 180 s window), with the rate the window
    estimator gives along those arrivals and scalar rates, availability
    from none to a large pool (ints and 0-d tensors on the card), and
    thresholds float32 represents or not, with the last requests' sizes
    and rates at their float32 neighbours."""
    import numpy as np

    from repro_torch.core.placing import placing_batch_torch
    from repro_torch.core.telemetry import FrequencyEstimator
    from repro_torch.core.workload import ramp

    reqs = ramp(7000, dist="bimodal", seed=7000)
    fe = FrequencyEstimator(window_s=180.0)
    f_t = []
    for r in reqs:
        fe.observe(r.arrival_t)
        f_t.append(fe.frequency(r.arrival_t))
    seen = set()
    for F, D in ((1200.0, 1e6), (1200.3, 16777217.0)):
        edge = [float(np.nextafter(np.float32(x), np.float32(d))) for x in (F, D) for d in (-np.inf, np.inf)]
        edge += [float(np.float32(F)), float(np.float32(D))]
        sizes = torch.tensor(np.array([r.data_size for r in reqs][:-6] + edge, np.float32))
        rates = torch.tensor(f_t[:-6] + edge, dtype=torch.float32)
        for ft in (rates, 900.0, 5000.0):
            for ff, df in ((0, 0), (4, 8), (64, 512), (10**6, 10**6)):
                want = placing_batch_torch(ft, sizes, ff, df, F=F, D=D)
                seen |= set(want.tolist())
                ft_d = ft.to(cuda_device) if isinstance(ft, torch.Tensor) else ft
                for a, b in ((ff, df), (torch.tensor(ff, device=cuda_device),
                                        torch.tensor(df, device=cuda_device))):
                    got = placing_batch_torch(ft_d, sizes.to(cuda_device), a, b, F=F, D=D)
                    assert got.device.type == "cuda" and got.dtype == torch.int32
                    assert torch.equal(got.cpu(), want), (F, D, ff, df)
    assert seen == {0, 1, 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_quantize_weight_matches_cpu(cuda_device, dt):
    """``quantize_weight`` on the card equals the CPU bit for bit (int8
    values and bf16 scale bits) at granite-8b's w1 (4096, 14336), with a
    zero column and a column of .5 ties; ``quantize_params`` of a stacked
    leaf on the card equals the CPU's too."""
    from repro_torch.models.quant import quantize_params, quantize_weight

    g = torch.Generator().manual_seed(0)
    w = torch.randn(4096, 14336, generator=g) * 0.015625
    w[:, 0] = 0.0
    w[:, 1] = (torch.arange(4096) % 8) - 3.5
    w[0, 1] = 127.0
    w = w.to(dt)
    want, got = quantize_weight(w), quantize_weight(w.to(cuda_device))
    assert torch.equal(got["q"].cpu(), want["q"])
    assert torch.equal(got["s"].cpu().view(torch.int16), want["s"].view(torch.int16))
    stacked = {"w2": torch.randn(3, 1024, 512, generator=g).to(dt)}
    a, b = quantize_params(stacked)["w2"], quantize_params(_map(stacked, lambda t: t.to(cuda_device)))["w2"]
    assert torch.equal(b["q"].cpu(), a["q"]) and torch.equal(b["s"].cpu().view(torch.int16),
                                                              a["s"].view(torch.int16))


@pytest.mark.cuda
def test_cuda_qeinsum_matches_cpu(cuda_device):
    """The int8 product on the card (bf16 weights from int8, cuBLAS with f32
    output, the scales, a bf16 cast) against the CPU's f32 product at
    granite-8b's widths, bf16 activations, within 2e-2; f32 within 2e-5."""
    from repro_torch.models.quant import qeinsum, quantize_weight

    g = torch.Generator().manual_seed(1)
    for xs, ws in (((8, 1, 4096), (4096, 1024)), ((2, 16, 14336), (14336, 4096)),
                   ((8, 4096), (4096, 49152)), ((4096,), (4096, 49152))):
        w = quantize_weight(torch.randn(ws, generator=g) / ws[0] ** 0.5)
        wd = _map(w, lambda t: t.to(cuda_device))
        for dt in (torch.bfloat16, torch.float32):
            x = (torch.randn(xs, generator=g) * 0.25).to(dt)
            want = qeinsum(x, w)
            got = qeinsum(x.to(cuda_device), wd)
            assert got.dtype == dt and got.shape == want.shape
            err = float((got.cpu().float() - want.float()).abs().max())
            assert err < TOL[dt], (xs, dt, err)


@pytest.mark.cuda
def test_cuda_int8_weights_engine_matches_cpu_engine(cuda_device):
    """A paged engine serving granite-8b SMOKE in f32 with int8 weights on
    the card (every kernel of the path, the product in f32 on int8 weights)
    and on the CPU, the same quantized tree: identical greedy streams, in
    16-token chunks on an f32 pool and whole-prompt on an int8 pool with
    chained tables."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model
    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine

    cfg = get_config("granite-8b", smoke=True).replace(attn_chunk=64, weights_int8=True)
    model = get_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(0))
    gpu_params = _map(cpu_params, lambda t: t.to(cuda_device))
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist() for n in (5, 19, 30, 8)]
    for kw in (dict(chunk_tokens=16), dict(cache_dtype="int8", chained_tables=True, table_page_entries=2)):
        kw.update(page_size=8, num_pages=33, max_slots=3, max_seq_len=64, max_new_tokens=6)
        want = [s.out for s in PagedInferenceEngine(cfg, PagedEngineConfig(**kw), params=cpu_params,
                                                    device="cpu").generate(prompts)]
        got = [s.out for s in PagedInferenceEngine(cfg, PagedEngineConfig(**kw), params=gpu_params,
                                                   device=cuda_device).generate(prompts)]
        assert got == want, kw


def _launches(fn):
    """Launches of the rmsnorm, flash and dense decode kernels during ``fn()``."""
    from repro_torch.kernels import _build

    wrappers = {"rmsnorm": rms_ops.rmsnorm, "flash": fa_ops.flash_attention_bhsd,
                "decode": da_ops.decode_attention}
    for w in wrappers.values():
        _build.reset_launches(w)
    out = fn()
    torch.cuda.synchronize()
    return out, {name: w.launches for name, w in wrappers.items()}


def _close_trees(a, b, tol=1e-4):
    if isinstance(a, dict):
        for k in a:
            _close_trees(a[k], b[k], tol)
    else:
        assert (a.cpu().float() - b.float()).abs().max() < tol


def _rotary_f64(x, ang):
    """x (B, S, H, hd) rotated by the angles (B, S, hd/2), all in f64."""
    x1, x2 = torch.chunk(x.double(), 2, dim=-1)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _rotary_bound(x, ang, want, dt):
    """Per-element bound on the f32 rotary's error against the f64 one: the
    f32 angle (frequency and product) within 4 units of rounding of the
    angle, cos, sin and the rotation's products within 8 more, times
    |x1| + |x2|; in bf16 the output's rounding (2^-8 of it) on top. It grows
    with the position, as every f32 RoPE's error does."""
    u = 2.0 ** -24
    x1, x2 = torch.chunk(x.double().abs(), 2, dim=-1)
    per = (4 * u * ang.abs() + 8 * u)[..., None, :] * (x1 + x2)
    per = torch.cat([per, per], dim=-1)
    return per if dt == torch.float32 else 1.01 * per + 2.0 ** -8 * want.abs()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_apply_mrope_matches_cpu(cuda_device, dt):
    """M-RoPE (plain torch) on the card and on the CPU, each against the
    same rotation in f64, at qwen2-vl-2b's width, x (2, 96, 12, 128), at an
    8 x 8 image prompt's positions plus offsets up to 32000 (the model's
    context is 32768): every element within ``_rotary_bound``, which scales
    with the angle; the card's and the CPU's largest errors are printed."""
    from repro_torch.models.rotary import apply_mrope
    from repro_torch.models.vlm import mrope_positions_with_image

    g = torch.Generator().manual_seed(12)
    x = torch.randn(2, 96, 12, 128, generator=g).to(dt)
    pos = mrope_positions_with_image(2, 96, 16, 8, 8) + torch.randint(0, 32000, (3, 2, 1), generator=g,
                                                                      dtype=torch.int32)
    sections = (16, 24, 24)
    inv = 1.0 / (1e6 ** (torch.arange(0, 128, 2, dtype=torch.float64) / 128))
    ang = pos.double()[..., None] * inv
    bounds = [0, 16, 40, 64]
    ang = torch.cat([ang[i, ..., bounds[i]:bounds[i + 1]] for i in range(3)], dim=-1)
    want = _rotary_f64(x, ang)
    bound = _rotary_bound(x, ang, want, dt)
    cpu = apply_mrope(x, pos, 1e6, sections)
    card = apply_mrope(x.to(cuda_device), pos.to(cuda_device), 1e6, sections).cpu()
    for name, got in (("cpu", cpu), ("card", card)):
        d = (got.double() - want).abs()
        print(f"apply_mrope {dt} {name}: max |d| {float(d.max()):.3e}, max |d| / bound "
              f"{float((d / bound).max()):.3f}")
        assert got.dtype == dt and bool((d <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_apply_rope_matches_cpu(cuda_device, dt):
    """RoPE (plain torch, every decoder model's) on the card and on the CPU,
    each against the rotation in f64, x (2, 96, 12, 128) at positions
    offset by up to 32000, theta 1e4 and 1e6: every element within
    ``_rotary_bound``."""
    from repro_torch.models.rotary import apply_rope, positions_for

    g = torch.Generator().manual_seed(13)
    x = torch.randn(2, 96, 12, 128, generator=g).to(dt)
    pos = positions_for(2, 96) + torch.randint(0, 32000, (2, 1), generator=g, dtype=torch.int32)
    for theta in (1e4, 1e6):
        inv = 1.0 / (theta ** (torch.arange(0, 128, 2, dtype=torch.float64) / 128))
        ang = pos.double()[..., None] * inv
        want = _rotary_f64(x, ang)
        bound = _rotary_bound(x, ang, want, dt)
        for name, got in (("cpu", apply_rope(x, pos, theta)),
                          ("card", apply_rope(x.to(cuda_device), pos.to(cuda_device), theta).cpu())):
            d = (got.double() - want).abs()
            print(f"apply_rope theta {theta:g} {dt} {name}: max |d| {float(d.max()):.3e}, max |d| / bound "
                  f"{float((d / bound).max()):.3f}")
            assert got.dtype == dt and bool((d <= bound).all())


@pytest.mark.cuda
def test_cuda_qwen2_vl_matches_cpu(cuda_device):
    """qwen2-vl-2b SMOKE in f32 (standard-normal q/k/v biases) on the card
    against the CPU through ``EmbedsLM.prefill``: a text prompt's token
    embeddings at the default positions (one flash and two rmsnorm launches
    a layer), an image prompt's at its M-RoPE positions (no flash launch), and four decode steps after it (one decode_attention a
    layer each): equal tokens, caches within 1e-4."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model
    from repro_torch.models.vlm import mrope_positions_with_image

    cfg = get_config("qwen2-vl-2b", smoke=True)
    model, L = get_model(cfg), cfg.n_layers
    cpu = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    for name in ("bq", "bk", "bv"):
        cpu["blocks"]["l0_mixer"][name].copy_(torch.randn(cpu["blocks"]["l0_mixer"][name].shape, generator=g))
    gpu = _map(cpu, lambda t: t.to(cuda_device))
    text = cpu["embedding"][torch.randint(1, cfg.vocab_size, (2, 16), generator=g)]
    want, wc = model.prefill(cpu, {"inputs_embeds": text})
    (got, gc), n = _launches(lambda: model.prefill(gpu, {"inputs_embeds": text.to(cuda_device)}))
    assert torch.equal(got.cpu(), want) and n == {"rmsnorm": 2 * L + 1, "flash": L, "decode": 0}
    _close_trees(gc, wc)
    emb, pos = torch.randn(2, 24, cfg.d_model, generator=g), mrope_positions_with_image(2, 24, 4, 4, 4)
    want, wc = model.prefill(cpu, {"inputs_embeds": emb, "positions": pos}, cap=28)
    (got, gc), n = _launches(lambda: model.prefill(gpu, {"inputs_embeds": emb.to(cuda_device),
                                                         "positions": pos.to(cuda_device)}, cap=28))
    assert torch.equal(got.cpu(), want) and n == {"rmsnorm": 2 * L + 1, "flash": 0, "decode": 0}
    for j in range(4):
        want, wc = model.decode(cpu, wc, {"token": want[:, None], "cache_index": 24 + j})
        (got, gc), n = _launches(lambda b={"token": got[:, None], "cache_index": 24 + j}, c=gc:
                                 model.decode(gpu, c, b))
        assert torch.equal(got.cpu(), want) and n == {"rmsnorm": 2 * L + 1, "flash": 0, "decode": L}
    _close_trees(gc, wc)


@pytest.mark.cuda
def test_cuda_whisper_matches_cpu(cuda_device):
    """whisper-large-v3 SMOKE in f32 (standard-normal layernorm biases) on
    the card against the CPU: ``EncDecLM.prefill`` over seeded frames (one
    flash launch a decoder layer, no rmsnorm) and four decode steps (one
    decode_attention a layer each): equal tokens, caches (cross K/V
    included) within 1e-4."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model

    cfg = get_config("whisper-large-v3", smoke=True)
    model, L = get_model(cfg), cfg.n_layers
    cpu = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    for part in (cpu["decoder"], cpu["encoder"]):
        for leaves in list(part["blocks"].values()) + [part["final_norm"]]:
            if "b" in leaves:
                leaves["b"].copy_(torch.randn(leaves["b"].shape, generator=g))
    gpu = _map(cpu, lambda t: t.to(cuda_device))
    frames, toks = torch.randn(2, cfg.encoder.n_ctx, cfg.d_model, generator=g), torch.randint(1, 500, (2, 7))
    want, wc = model.prefill(cpu, {"frames": frames, "tokens": toks}, cap=12)
    (got, gc), n = _launches(lambda: model.prefill(gpu, {"frames": frames.to(cuda_device), "tokens": toks},
                                                   cap=12))
    assert torch.equal(got.cpu(), want) and n == {"rmsnorm": 0, "flash": L, "decode": 0}
    for j in range(4):
        want, wc = model.decode(cpu, wc, {"token": want[:, None], "cache_index": 7 + j})
        (got, gc), n = _launches(lambda b={"token": got[:, None], "cache_index": 7 + j}, c=gc:
                                 model.decode(gpu, c, b))
        assert torch.equal(got.cpu(), want) and n == {"rmsnorm": 0, "flash": 0, "decode": L}
    _close_trees(gc, wc)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tree_leaves(v)
    else:
        yield tree


def _moe_layer(E, k, T, d=256, f=512, seed=0):
    """An MoE layer's f32 weights and input on the CPU, unit-scale outputs."""
    from repro_torch.configs import dbrx_132b
    from repro_torch.models.common import MoECfg

    cfg = dbrx_132b.SMOKE.replace(d_model=d, d_ff=f, moe=MoECfg(n_experts=E, top_k=k))
    g = torch.Generator().manual_seed(seed)
    p = {"router": torch.randn(d, E, generator=g) / d ** 0.5,
         "w1": torch.randn(E, d, f, generator=g) / d ** 0.5,
         "w3": torch.randn(E, d, f, generator=g) / d ** 0.5,
         "w2": torch.randn(E, f, d, generator=g) / f ** 0.5}
    return cfg, p, torch.randn(2, T // 2, d, generator=g)


def _kept(cfg, p, x):
    """Each token's kept experts, as a (T, E) bool: routing from the layer's
    own router logits (the plain functions, on x's device)."""
    from repro_torch.models import moe

    xf = x.reshape(-1, x.shape[-1])
    T = xf.shape[0]
    r = moe.route(cfg, xf.float() @ p["router"].float(), moe.capacity_for(cfg, T))
    kept = torch.zeros(cfg.moe.n_experts, T, dtype=torch.bool, device=x.device)
    kept.scatter_(1, r["sel_idx"], r["sel_valid"])
    return kept.T.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("E,k", [(16, 4), (128, 1)])
def test_cuda_moe_ffn_matches_cpu(cuda_device, E, k):
    """``moe_ffn`` on the card in bf16 against the CPU in f32, d 256, f 512,
    64 tokens at the default capacity factor: on every token whose kept
    experts agree (most of them; bf16 router inputs may move a near tie),
    outputs within bf16's 2e-2; two calls on the card give the same bits."""
    from repro_torch.models import moe

    cfg, p, x = _moe_layer(E, k, 64)
    want, aux = moe.moe_ffn(cfg, p, x)
    gp = {n: t.to(cuda_device, torch.bfloat16) for n, t in p.items()}
    gx = x.to(cuda_device, torch.bfloat16)
    got, gaux = moe.moe_ffn(cfg.replace(compute_dtype=torch.bfloat16), gp, gx)
    again, _ = moe.moe_ffn(cfg.replace(compute_dtype=torch.bfloat16), gp, gx)
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    same = (_kept(cfg, p, x) == _kept(cfg, gp, gx)).all(1)
    d = (got.float().cpu() - want).abs().reshape(-1, x.shape[-1]).amax(1)
    print(f"moe_ffn E {E} top-{k}: {int(same.sum())} of {same.numel()} tokens route alike, max |d| there "
          f"{float(d[same].max()):.3e}, aux {float(aux):.5f} / {float(gaux):.5f}")
    assert int(same.sum()) >= 0.9 * same.numel()
    assert float(d[same].max()) < TOL[torch.bfloat16] * max(1.0, float(want.abs().max()))
    assert abs(float(aux) - float(gaux)) < 0.05 * float(aux)


@pytest.mark.cuda
def test_cuda_blocked_init_peak(cuda_device):
    """``DecoderLM.init`` of one dbrx-132b layer at full width with 4
    experts (a (1, 4, 6144, 10752) expert leaf, 264 M values, over BLOCK)
    and a 1024-token vocabulary: the peak stays within the tree plus 1 GiB
    (a whole-leaf f32 draw would add 2 GiB), and the leaf's draws have the
    init's scale."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model
    from repro_torch.models.common import MoECfg

    cfg = get_config("dbrx-132b").replace(n_layers=1, vocab_size=1024, moe=MoECfg(n_experts=4, top_k=2))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = get_model(cfg).init(torch.Generator(cuda_device).manual_seed(0))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    tree = sum(t.numel() * t.element_size() for t in _tree_leaves(params))
    w1 = params["blocks"]["l0_ffn"]["w1"]
    std = float(w1[0, 3].float().std()) * 6144 ** 0.5
    print(f"blocked init: tree {tree} B, peak {peak} B (+{(peak - tree) / 2**20:.1f} MiB), w1 std x sqrt(d) {std:.4f}")
    assert peak < tree + 2**30 and abs(std - 1.0) < 0.01
    del params
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_cuda_mamba_mixer_bf16_matches_cpu_f32(cuda_device):
    """``mamba_mixer`` at a mid width (d 1024, d_inner 2048, d_state 16,
    chunk 128; standard-normal conv_b, dt_bias and A_log) in bf16 on the
    card against f32 on the CPU: a prefill of 256 tokens (two chunks; the
    second row padded after 200), then 4 decode steps. The output sequence
    and the final conv and ssm states within bf16 2e-2 of the largest f32
    magnitude; two runs on the card bit-identical."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import mamba as mam
    from repro_torch.models.common import MambaCfg, init_tree

    cfg = get_config("jamba-1.5-large-398b", smoke=True).replace(
        d_model=1024, mamba=MambaCfg(d_state=16, d_conv=4, expand=2, chunk=128))
    g = torch.Generator().manual_seed(0)
    p = init_tree(g, mam.mamba_defs(cfg), torch.float32, "cpu")
    for name in ("conv_b", "dt_bias", "A_log"):
        p[name] = torch.randn(p[name].shape, generator=g)
    x = torch.randn(2, 260, 1024, generator=g)
    valid = torch.arange(256)[None] < torch.tensor([[256], [200]])

    def run(dt, dev):
        c = cfg.replace(param_dtype=dt, compute_dtype=dt)
        pc = {k: v.to(dev, dt) for k, v in p.items()}
        cache = {n: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                 for n, s in mam.mamba_cache_defs(c, 2).items()}
        out, cache = mam.mamba_mixer(c, pc, x[:, :256].to(dev, dt), "prefill", cache,
                                     valid=valid.to(dev))
        outs = [out]
        for j in range(256, 260):
            o, cache = mam.mamba_mixer(c, pc, x[:, j:j + 1].to(dev, dt), "decode", cache)
            outs.append(o)
        return torch.cat(outs, 1), cache

    want, wc = run(torch.float32, "cpu")
    got, gc = run(torch.bfloat16, cuda_device)
    again, ac = run(torch.bfloat16, cuda_device)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and gc["ssm"].dtype == torch.float32
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, again) and all(torch.equal(gc[n], ac[n]) for n in gc)
    assert _scaled_err(got.cpu(), want) < TOL[torch.bfloat16]
    for name in ("conv", "ssm"):
        a, b = gc[name].cpu().float(), wc[name]
        assert float((a - b).abs().max()) / float(b.abs().max()) < TOL[torch.bfloat16], name


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_tokens", [0, 16], ids=["whole_prompt", "chunked"])
def test_cuda_jamba_paged_engine_matches_cpu_engine(cuda_device, chunk_tokens):
    """The paged engine serving jamba-1.5-large SMOKE in f32 (capacity
    factor 8, standard-normal conv_b, dt_bias and A_log) on the card and on
    the CPU, on the same weights: identical greedy streams, prompts across
    chunks so the Mamba carry crosses calls; the rmsnorm, page-pool write
    and paged decode kernels launched, flash on the whole-prompt leg."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model
    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine

    cfg = get_config("jamba-1.5-large-398b", smoke=True)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    cpu_params = get_model(cfg).init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "mamba":
            leaves = cpu_params["blocks"][f"l{i}_mixer"]
            for name in ("conv_b", "dt_bias", "A_log"):
                leaves[name].copy_(torch.randn(leaves[name].shape, generator=g))
    gpu_params = _map(cpu_params, lambda t: t.to(cuda_device))
    kw = dict(page_size=8, num_pages=33, max_slots=3, max_seq_len=64, max_new_tokens=6,
              chunk_tokens=chunk_tokens)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist() for n in (5, 19, 30, 8)]
    want = [s.out for s in PagedInferenceEngine(cfg, PagedEngineConfig(**kw), params=cpu_params,
                                                device="cpu").generate(prompts)]
    wrappers = (rms_ops.rmsnorm, pa_ops.paged_prefill_write, pa_ops.paged_attention,
                fa_ops.flash_attention_bhsd)
    before = [w.launches for w in wrappers]
    got = [s.out for s in PagedInferenceEngine(cfg, PagedEngineConfig(**kw), params=gpu_params,
                                               device=cuda_device).generate(prompts)]
    n = [w.launches - b for w, b in zip(wrappers, before)]
    assert min(n[:3]) > 0 and (n[3] > 0) == (chunk_tokens == 0), n
    assert got == want, (want, got)


@pytest.mark.cuda
def test_cuda_decode_kernels_at_jamba_G8(cuda_device):
    """Both decode kernels at jamba-1.5-large's attention shape, G 8 over 8
    KV heads, hd 128 (the 8-row head group, one block per (b, KV head,
    split)): the paged decode on every leg (f32 and bf16 pools, int8 pools,
    flat and chained tables) at batch 8 with the pools phase's lengths, and
    the dense decode over the launcher's cache and a 1000-token cache split
    across blocks; against the plain versions, two calls bit-identical,
    chained bit-identical to flat, one launch a call."""
    dev = cuda_device
    g = torch.Generator(dev).manual_seed(25)
    gen_tab = torch.Generator().manual_seed(25)
    G, KV, hd, ps, P, B = 8, 8, 128, 16, 16, 8
    lens_l = [120, 128, 129, 144, 161, 176, 193, 208]
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    for dt, quant in ((torch.bfloat16, False), (torch.float32, False), (torch.bfloat16, True),
                      (torch.float32, True)):
        pools, kw, tab, l1, l2 = _paged_setup(g, gen_tab, dev, B, KV, hd, ps, P, lens_l, dt, quant)
        q = torch.randn(B, 1, G * KV, hd, generator=g, device=dev).to(dt)
        before = pa_ops.paged_attention.launches
        out = pa_ops.paged_attention(q, *pools, tab, lens, **kw)
        assert pa_ops.paged_attention.launches == before + 1
        again = pa_ops.paged_attention(q, *pools, tab, lens, **kw)
        chained = pa_ops.paged_attention(q, *pools, l1, lens, l2_tab=l2, **kw)
        ref = paged_attention_ref(q[:, 0].reshape(B, KV, G, hd), *pools, tab, lens, **kw)
        assert torch.isfinite(out.float()).all() and torch.equal(out, again) and torch.equal(out, chained)
        err = float((out.reshape(B, KV, G, hd).float() - ref.float()).abs().max())
        assert err < TOL[dt], (dt, quant, err)
    for dt in (torch.bfloat16, torch.float32):
        for Bd, T, lens_d in ((4, 96, [1, 9, 57, 96]), (4, 1000, [1, 333, 777, 1000])):
            q = torch.randn(Bd, 1, G * KV, hd, generator=g, device=dev).to(dt)
            cache = torch.randn(2, Bd, T, KV, hd, generator=g, device=dev).to(dt)
            ln = torch.tensor(lens_d, dtype=torch.int32, device=dev)
            before = da_ops.decode_attention.launches
            out = da_ops.decode_attention(q, cache[0], cache[1], ln)
            assert da_ops.decode_attention.launches == before + 1
            again = da_ops.decode_attention(q, cache[0], cache[1], ln)
            ref = decode_attention_ref(q[:, 0].reshape(Bd, KV, G, hd), cache[0].transpose(1, 2),
                                       cache[1].transpose(1, 2), ln)
            assert torch.isfinite(out.float()).all() and torch.equal(out, again)
            err = float((out.reshape(Bd, KV, G, hd).float() - ref.float()).abs().max())
            assert err < TOL[dt], (dt, T, err)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_batched_qeinsum_matches_f64_and_cpu(cuda_device):
    """The experts' int8 product on the card (``torch.bmm`` on the bf16
    copy of the int8 weight, f32 output, the (E, 1, f) scales, one rounding
    into bf16) at jamba-1.5-large's w1 and w2 shapes over 4 experts: within
    0.55 bf16 ulp of the f64 product and 1 ulp of the CPU's f32 product; f32
    activations within 2e-5 of the CPU; ``quantize_weight`` of the 3-D leaf
    equal to the CPU's bit for bit."""
    from repro_torch.models.quant import qeinsum, quantize_weight

    g = torch.Generator().manual_seed(4)
    for xs, ws in (((4, 8, 8192), (4, 8192, 2048)), ((4, 8, 2048), (4, 2048, 8192))):
        w = (torch.randn(ws, generator=g) / ws[1] ** 0.5).to(torch.bfloat16)
        host, card = quantize_weight(w), quantize_weight(w.to(cuda_device))
        assert torch.equal(card["q"].cpu(), host["q"])
        assert torch.equal(card["s"].cpu().view(torch.int16), host["s"].view(torch.int16))
        assert tuple(card["s"].shape) == (ws[0], 1, ws[2])
        x = torch.randn(xs, generator=g).to(torch.bfloat16)
        got, want = qeinsum(x.to(cuda_device), card), qeinsum(x, host)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape == (xs[0], xs[1], ws[2])
        exact = torch.bmm(x.double(), host["q"].double()) * host["s"].double()
        ulp = 2.0 ** (torch.floor(torch.log2(exact.abs().clamp_min(float(exact.abs().max()) / 256))) - 7)
        got = got.cpu().double()
        assert float(((got - exact).abs() / ulp).max()) <= 0.55
        assert float(((got - want.double()).abs() / ulp).max()) <= 1.0
        x32 = x.float()
        err = float((qeinsum(x32.to(cuda_device), card).cpu() - qeinsum(x32, host)).abs().max())
        assert err < TOL[torch.float32], err


def _first_flip_leads(model, params, prompts, want, got):
    """For each stream where the card's tokens ``got`` leave the CPU's
    ``want``: the CPU f32 logits' lead of its own top token over the card's
    at the first differing step, teacher-forced on the card's tokens."""
    leads = []
    for p, a, b in zip(prompts, want, got):
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        with torch.no_grad():
            row = model.logits(params, model.hidden(params, [p + b[:j]]))[0, -1]
        leads.append(float(row.max() - row[b[j]]))
    return leads


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["dbrx-132b", "jamba-1.5-large-398b"])
def test_cuda_int8_moe_and_hybrid_paged_engines_match_cpu(cuda_device, arch, dt):
    """A paged engine serving dbrx-132b or jamba-1.5-large SMOKE with int8
    weights (capacity factor 8; jamba's conv_b, dt_bias and A_log standard
    normal) on the card and an f32 one on the CPU, on the same values, 16-
    token chunks: in f32 the card's greedy streams equal the CPU's; in bf16
    (the experts' products through ``torch.bmm``) every stream equals the
    CPU's or leaves it where the CPU's f32 lead of its own token is under
    0.25. The rmsnorm, page-pool write and paged decode kernels launched."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import get_model
    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine

    cfg = get_config(arch, smoke=True).replace(weights_int8=True)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = get_model(cfg).init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(3)
    for key, leaves in params["blocks"].items():
        for name in ("conv_b", "dt_bias", "A_log"):
            if key.endswith("_mixer") and name in leaves:
                leaves[name].copy_(torch.randn(leaves[name].shape, generator=g))
    card_dt = getattr(torch, dt)
    card_cfg = cfg.replace(param_dtype=card_dt, compute_dtype=card_dt)
    cpu_params = _map(params, lambda t: t.to(card_dt).float() if t.dtype == torch.float32 else t)
    gpu_params = _map(params, lambda t: t.to(cuda_device, card_dt if t.dtype == torch.float32 else t.dtype))
    kw = dict(page_size=8, num_pages=33, max_slots=3, max_seq_len=64, max_new_tokens=6, chunk_tokens=16)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist() for n in (5, 19, 30, 8)]
    want = [s.out for s in PagedInferenceEngine(cfg, PagedEngineConfig(**kw), params=cpu_params,
                                                device="cpu").generate(prompts)]
    wrappers = (rms_ops.rmsnorm, pa_ops.paged_prefill_write, pa_ops.paged_attention)
    before = [w.launches for w in wrappers]
    got = [s.out for s in PagedInferenceEngine(card_cfg, PagedEngineConfig(**kw), params=gpu_params,
                                               device=cuda_device).generate(prompts)]
    assert min(w.launches - b for w, b in zip(wrappers, before)) > 0
    assert all(len(o) == 6 for o in got)
    if dt == "float32":
        assert got == want, (want, got)
    else:
        leads = _first_flip_leads(get_model(cfg), cpu_params, prompts, want, got)
        assert max(leads, default=0.0) < 0.25, leads


# ---------------------------------------------------------------------------
# Training: the kernels' autograd Functions, the forward-only kernels, a step
# ---------------------------------------------------------------------------


def _fn_and_plain_grads(fn, plain, inputs, seed=0):
    """(outputs, gradients) of sum(out * r) over every output, r a seeded
    normal per output, through ``fn`` and through the plain version's own
    autograd, for every floating input."""
    res = []
    for f in (fn, plain):
        xs = [x.detach().clone().requires_grad_(x.is_floating_point()) for x in inputs]
        outs = f(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        g = torch.Generator(xs[0].device).manual_seed(seed)
        total = sum((o.float() * torch.randn(o.shape, generator=g, device=o.device)).sum() for o in outs)
        res.append(([o.detach() for o in outs], torch.autograd.grad(total, [x for x in xs if x.requires_grad])))
    return res


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cuda_autograd_functions_match_plain_autograd(cuda_device, dt):
    """Each Function on the card (the kernel forward, one launch, the plain
    version's backward) against the plain version's autograd on the same
    inputs: outputs and every gradient within f32 2e-5 / bf16 2e-2 of the
    largest (or of 1). rmsnorm at (64, 960); flash in both layouts at a
    ragged S 37 over 15 heads on 5; mLSTM at (4, 48, 64) in chunks of 16 from
    a non-zero carry, h and the carry outputs all carrying gradients."""
    from repro_torch.kernels.mlstm_chunk import ops as mk_ops
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunkwise_bh_ref

    dev = cuda_device
    g = torch.Generator(dev).manual_seed(11)
    tol = TOL[dt]

    def r(*s, scale=1.0):
        return (torch.randn(s, generator=g, device=dev) * scale).to(dt)

    q4, k4, v4 = r(2, 37, 15, 64), r(2, 37, 5, 64), r(2, 37, 5, 64)
    mq = _mlstm_inputs(g, dev, 4, 48, 64, dt)
    carry = (torch.randn(4, 64, 64, generator=g, device=dev) * 0.1,
             torch.randn(4, 64, generator=g, device=dev) * 0.1, torch.randn(4, generator=g, device=dev))
    cases = [
        ("rmsnorm", rms_ops.rmsnorm, rmsnorm_ref, (r(64, 960), 0.5 + r(960).abs()), 1),
        ("flash bshd", fa_ops.flash_attention,
         lambda q, k, v: fa_ops._plain(q, k, v, "bshd"), (q4, k4, v4), 1),
        ("flash bhsd", fa_ops.flash_attention_bhsd, attention_ref,
         tuple(t.transpose(1, 2).contiguous() for t in (q4, k4, v4)), 1),
        ("mlstm", lambda *a: mk_ops.mlstm_chunkwise_bh(*a, chunk=16),
         lambda *a: mlstm_chunkwise_bh_ref(*a, chunk=16), (*mq, *carry), 1),
    ]
    for name, fn, plain, inputs, launches in cases:
        counter = mk_ops.mlstm_chunkwise_bh if name == "mlstm" else (
            rms_ops.rmsnorm if name == "rmsnorm" else fa_ops.flash_attention_bhsd)
        before = counter.launches
        (o_k, g_k), (o_p, g_p) = _fn_and_plain_grads(fn, plain, inputs)
        assert counter.launches - before == launches, name
        for i, (a, b) in enumerate(zip(o_k + list(g_k), o_p + list(g_p))):
            assert a.dtype == b.dtype and a.shape == b.shape, (name, i)
            assert _scaled_err(a, b) < tol, (name, i, _scaled_err(a, b))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_forward_only_kernels_raise_under_grad(cuda_device):
    """The dense and paged decode and both page-pool writes have no backward:
    each raises (naming itself) when grad is on and an input requires it,
    and launches as before under ``torch.no_grad()``."""
    dev = cuda_device
    g = torch.Generator(dev).manual_seed(12)
    q = torch.randn(2, 1, 6, 64, generator=g, device=dev, requires_grad=True)
    kc = torch.randn(2, 16, 2, 64, generator=g, device=dev)
    pool = torch.zeros(5, 2, 8, 64, device=dev)
    tab = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=dev)
    lens = torch.tensor([5, 9], dtype=torch.int32, device=dev)
    k = torch.randn(1, 9, 2, 64, generator=g, device=dev, requires_grad=True)
    qk = torch.zeros(5, 2, 8, 64, dtype=torch.int8, device=dev)
    sk = torch.zeros(5, 2, 8, 1, dtype=torch.bfloat16, device=dev)
    calls = {
        "decode_attention": lambda: da_ops.decode_attention(q, kc, kc, lens),
        "paged_attention": lambda: pa_ops.paged_attention(q, pool, pool, tab, lens),
        "paged_prefill_write": lambda: pa_ops.paged_prefill_write(pool, pool.clone(), k, k, tab[0]),
        "paged_prefill_write_quant": lambda: pa_ops.paged_prefill_write_quant(qk, qk.clone(), sk, sk.clone(),
                                                                               k, k, tab[0]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=name):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()


GRAD_TOL = {"smollm-360m": 2e-5, "xlstm-350m": 1e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(GRAD_TOL))
def test_cuda_smoke_train_step_matches_cpu(cuda_device, arch):
    """Two train steps of the SMOKE model in f32 (TF32 off, remat full),
    each from the CPU's parameters and state: the loss within f32 2e-5 and
    every gradient on the card within GRAD_TOL of the CPU's (of the leaf's
    largest, or of 1), the AdamW update on the card from the CPU's
    gradients within 2e-5 of the CPU's; the rmsnorm (forward and
    recompute), flash and, for xLSTM, mLSTM kernels launched. (The update
    is held apart from the gradients: where a gradient is near AdamW's eps,
    a rounding in it moves the update by up to the learning rate.) smollm's
    gradients are held at 2e-5; xLSTM's at 1e-3: on the CPU alone, weights
    moved by 1e-7 of themselves (f32 rounding) move its SMOKE gradients by
    up to 3.4e-4 of a leaf's largest (smollm's by 6.3e-8), through its
    stabiliser maxima and normaliser clamps
    (``scripts/train_grad_sensitivity.py``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.mlstm_chunk import ops as mk_ops
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import get_model
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state
    from repro_torch.train.tree import leaves

    cfg = get_config(arch, smoke=True).replace(remat="full")
    model = get_model(cfg)
    ocfg = OptConfig(lr=1e-3)
    params = model.init(torch.Generator().manual_seed(0))
    state = init_opt_state(params, ocfg)
    data = SyntheticLM(DataConfig(batch_size=2, seq_len=32, vocab_size=cfg.vocab_size, seed=1))
    wrappers = (rms_ops.rmsnorm, fa_ops.flash_attention_bhsd, mk_ops.mlstm_chunkwise_bh)
    card = lambda tree: _map(tree, lambda t: t.to(cuda_device))  # noqa: E731
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
        before = [w.launches for w in wrappers]
        (l_gpu, _), g_gpu = value_and_grad(model, card(params), card(batch))
        n = [w.launches - b for w, b in zip(wrappers, before)]
        (l_cpu, _), g_cpu = value_and_grad(model, params, batch)
        assert abs(float(l_gpu) - float(l_cpu)) < TOL[torch.float32], i
        if arch == "smollm-360m":
            assert n == [2 * (2 * cfg.n_layers) + 1, 2 * cfg.n_layers, 0], n
        else:
            n_m = sum(k == "mlstm" for k in cfg.block_pattern) * cfg.n_superblocks
            assert n[2] == 2 * n_m and n[0] > 0, n
        for a, b in zip(leaves(g_gpu), leaves(g_cpu)):
            assert _scaled_err(a.cpu(), b) < GRAD_TOL[arch]
        p_gpu, _, _ = adamw_update(card(g_cpu), card(state), card(params), ocfg)
        params, state, _ = adamw_update(g_cpu, state, params, ocfg)
        for a, b in zip(leaves(p_gpu), leaves(params)):
            assert _scaled_err(a.cpu(), b) < TOL[torch.float32]


XC_LOGIT_TOL, XC_GRAD_TOL = 2e-5, 1e-4   # chip_smoke.py phase 17 (c)


@pytest.mark.cuda
@pytest.mark.parametrize("size,width", [(32, 8), (299, 16)])
def test_cuda_xception_step_matches_cpu(cuda_device, size, width):
    """The Xception analog (2 blocks) in f32, TF32 off: logits and loss on
    the card within 2e-5 of the CPU's (of their scale, or 1), every gradient
    leaf within 1e-4 of its largest CPU magnitude, and one SGD step's tree
    within 2e-5 of the CPU's; no kernel launched (cuDNN convolutions)."""
    import numpy as np

    from repro_torch.benchmarks.fig3_training import sgd_step, task_batch
    from repro_torch.models import xception

    cfg = xception.XceptionConfig(img_size=size, width=width, n_blocks=2)
    params = xception.init(torch.Generator().manual_seed(3), cfg, "cpu")
    img, lab = (torch.from_numpy(a) for a in task_batch(np.random.default_rng(size), 4, size))
    card = {k: v.to(cuda_device) for k, v in params.items()}
    before = [w.launches for w in WRAPPERS]
    with torch.no_grad():
        logits = xception.forward(cfg, card, img.to(cuda_device)).cpu()
        logits_cpu = xception.forward(cfg, params, img)
    assert _scaled_err(logits, logits_cpu) <= XC_LOGIT_TOL
    (l_gpu, _), g_gpu = xception.value_and_grad(cfg, card, img.to(cuda_device), lab.to(cuda_device))
    (l_cpu, _), g_cpu = xception.value_and_grad(cfg, params, img, lab)
    assert abs(float(l_gpu) - float(l_cpu)) <= XC_LOGIT_TOL * max(1.0, abs(float(l_cpu)))
    for k in g_cpu:
        assert float((g_gpu[k].cpu() - g_cpu[k]).abs().max()) <= XC_GRAD_TOL * float(g_cpu[k].abs().max()), k
    p_gpu, _ = sgd_step(cfg, card, img.to(cuda_device), lab.to(cuda_device))
    p_cpu, _ = sgd_step(cfg, params, img, lab)
    for k in p_cpu:
        assert _scaled_err(p_gpu[k].cpu(), p_cpu[k]) <= TOL[torch.float32], k
    assert [w.launches for w in WRAPPERS] == before


@pytest.mark.cuda
def test_cuda_train_small_resumes_with_its_launches(cuda_device, tmp_path, capsys):
    """``launch/train_small`` on the card (its default device) at 40 steps:
    the crash at 20, the resume from the checkpoint at 20, the loss falling,
    and 2L + 1 rmsnorm and L flash launches a smollm SMOKE step (remat
    none), no other kernel."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train_small

    L = get_config("smollm-360m", smoke=True).n_layers
    before = [w.launches for w in WRAPPERS]
    r = train_small.main(["--steps", "40", "--ckpt-dir", str(tmp_path / "ck")])
    n = [w.launches - b for w, b in zip(WRAPPERS, before)]
    assert r["resumed_from"] == 20 and r["resumed"]["steps_done"] == 40
    assert "OK — checkpoint/restart training complete" in capsys.readouterr().out
    assert n == [40 * (2 * L + 1), 0, 0, 0, 40 * L, 0], n


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_cuda_cost_counter_matches_meta(cuda_device, kind):
    """A smollm SMOKE train step and a dense decode step counted on the card
    (the kernels reporting their own work) equal the meta trace of the same
    shapes: FLOPs, operation traffic and argument bytes."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import cost, steps
    from repro_torch.models import get_model
    from repro_torch.models.api import ShapeSpec
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    B, S = 2, 16
    model = get_model(get_config("smollm-360m", smoke=True))
    gen = torch.Generator(cuda_device).manual_seed(0)
    params = model.init(gen)
    ids = lambda *s: torch.randint(0, model.cfg.vocab_size, s, generator=gen, device=cuda_device,  # noqa: E731
                                   dtype=torch.int32)
    spec = ShapeSpec(kind, kind, S, B)
    if kind == "train":
        step = steps.make_train_step(model, OptConfig())
        args = (params, init_opt_state(params, OptConfig()), {"tokens": ids(B, S), "labels": ids(B, S)})
        low = steps.lower_train(model, spec, OptConfig())
    else:
        step = steps.make_decode_step(model)
        args = (params, model.init_cache(B, S, cuda_device), {"token": ids(B, 1), "cache_index": S - 1})
        low = steps.lower_decode(model, spec)
    before = rms_ops.rmsnorm.launches
    _, card = cost.step_cost(lambda: step(*args), args)
    torch.cuda.synchronize()
    assert rms_ops.rmsnorm.launches > before            # the kernels ran
    _, meta = cost.step_cost(low, low.args, low.donated)
    assert (card["flops"], card["mem_bytes"], card["argument_bytes"]) == (
        meta["flops"], meta["mem_bytes"], meta["argument_bytes"])


@pytest.mark.cuda
def test_cuda_engine_loop_soak_under_witness(cuda_device):
    """A smollm-360m SMOKE paged engine under an EngineLoop on the card,
    with the loop's registry lock, the engine's step RLock and ``_build``'s
    build and count locks witnessed while five submitter threads run the
    admit->resolve cycle (the last prompt repeats the first): every stream
    complete, the repeat equal to its first, the three kernels of the path
    launched, the engine's step lock seen taking the count lock (an edge
    the CPU soaks cannot see) and every observed order consistent with the
    port's static lock-order graph."""
    from repro_torch.analysis.__main__ import build_graph, repo_root
    from repro_torch.analysis.witness import LockWitness, instrument_build, instrument_loop
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.serving.engine import PagedEngineConfig, PagedInferenceEngine
    from repro_torch.serving.scheduler import EngineLoop

    cfg = get_config("smollm-360m", smoke=True).replace(attn_chunk=64)
    eng = PagedInferenceEngine(cfg, PagedEngineConfig(page_size=16, num_pages=9, max_slots=2,
                                                      max_seq_len=64, max_new_tokens=3, chunk_tokens=16),
                               device=cuda_device)
    eng.prewarm()                       # builds the library before the loop thread exists
    w = LockWitness()
    loop = EngineLoop(eng)
    instrument_loop(loop, w)
    for fn in WRAPPERS:
        _build.reset_launches(fn)
    g = torch.Generator().manual_seed(3)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist() for n in (5, 21, 9, 30)]
    prompts.append(list(prompts[0]))
    outs = [None] * len(prompts)
    restore = instrument_build(w)
    try:
        with loop:
            def worker(i):
                outs[i] = loop.wait(loop.submit(prompts[i]), 120).out

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert not any(t.is_alive() for t in threads)
    finally:
        restore()
    assert all(len(o) == 3 for o in outs) and outs[4] == outs[0]
    assert rms_ops.rmsnorm.launches > 0 and pa_ops.paged_prefill_write.launches > 0
    assert pa_ops.paged_attention.leg_launches["flat"] > 0
    static = {(e.src, e.dst) for e in build_graph(repo_root()).edges}
    edge = ("_EngineBase.lock", "_build._count_lock")
    assert edge in static and edge in w.edge_set(strip_instances=True), w.edge_set()
    w.assert_consistent(static, reentrant={"_EngineBase.lock"})
