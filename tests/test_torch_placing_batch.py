"""``placing_batch_torch``, the port's vectorized Algorithm 1, on the CPU:
bit for bit the JAX package's ``placing_batch_jax`` on seeded batches (N 1 to
7000, scalar and vector rates, availability 0-8 and a large pool), and the
Python loop of ``StraightLinePolicy`` wherever the inputs are float32
values, as ``tests/test_placing.py`` holds the JAX version. At the float32
neighbours of F and D, and with thresholds that float32 cannot represent,
both vectorized versions compare in float32: they equal the loop under the
thresholds rounded to float32, and not under the unrounded ones."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.placing import placing_batch_jax  # noqa: E402
from repro_torch.core import Request, StraightLinePolicy, Thresholds, Tier  # noqa: E402
from repro_torch.core.placing import placing_batch_torch  # noqa: E402

F32 = np.float32


def f32(x: float) -> float:
    return float(F32(x))


def neighbours(x: float) -> list:
    """``x`` rounded to float32 and the float32 values on either side."""
    c = F32(x)
    return [float(np.nextafter(c, F32(-np.inf))), float(c), float(np.nextafter(c, F32(np.inf)))]


def loop(sizes, f_t, flask_free, docker_free, F, D) -> list:
    """The Python loop of ``place_all``, which consumes availability as it
    goes; with a rate per request, ``place`` is called with each one."""
    pol = StraightLinePolicy(Thresholds(F=F, D=D))
    reqs = [Request(rid=i, arrival_t=0.0, data_size=s) for i, s in enumerate(sizes)]
    if np.ndim(f_t) == 0:
        return [int(d.tier) for d in pol.place_all(reqs, f_t, flask_free, docker_free)]
    out, ff, df = [], flask_free, docker_free
    for r, f in zip(reqs, f_t):
        t = pol.place(r, float(f), ff, df).tier
        ff -= t == Tier.FLASK
        df -= t == Tier.DOCKER
        out.append(int(t))
    return out


def both(sizes, f_t, flask_free, docker_free, F, D):
    """(torch, jax) tier ids as lists, on float32 sizes and rates."""
    sizes = np.asarray(sizes, np.float32)
    vec = np.ndim(f_t) > 0
    t = placing_batch_torch(torch.from_numpy(np.asarray(f_t, np.float32)) if vec else f_t,
                            torch.from_numpy(sizes), flask_free, docker_free, F=F, D=D)
    # jnp.int32 cannot hold a pool past 2**31 - 1, which is as good as N
    j = placing_batch_jax(jnp.asarray(f_t, jnp.float32) if vec else f_t, jnp.asarray(sizes),
                          jnp.int32(min(flask_free, 2**31 - 1)),
                          jnp.int32(min(docker_free, 2**31 - 1)), F=F, D=D)
    assert t.dtype == torch.int32 and t.shape == (len(sizes),) and t.device.type == "cpu"
    return t.tolist(), np.asarray(j).tolist()


def draw(rng, n: int, F: float, D: float, vector: bool):
    """A batch whose sizes straddle D (its float32 neighbours included) and
    whose rates straddle F: float32 values throughout."""
    pool = np.concatenate([np.exp(rng.uniform(np.log(1.0), np.log(1e8), 64)),
                           neighbours(D), neighbours(F)])
    sizes = [f32(x) for x in rng.choice(pool, n)]
    rates = np.array([*neighbours(F), 0.0, 1e4], np.float32)
    f_t = rng.choice(rates, n) if vector else float(rng.choice(rates))
    return sizes, f_t


THRESHOLDS = [(1200.0, 1e6), (1000.0, 1e6 + 0.1), (1200.3, 16777217.0)]   # (F, D)
NS = [1, 2, 3, 7, 32, 100, 1000, 7000]


@pytest.mark.parametrize("th", [0, 1, 2], ids=["representable", "D_not", "F_D_not"])
@pytest.mark.parametrize("vector", [False, True], ids=["scalar_ft", "vector_ft"])
def test_batch_placer_matches_jax_and_the_loop(th, vector):
    F, D = THRESHOLDS[th]
    rng = np.random.default_rng(10 * th + vector)
    cases = 0
    for n in NS:
        for _ in range(6 if n <= 100 else 2):
            sizes, f_t = draw(rng, n, F, D, vector)
            for ff, df in [(int(rng.integers(0, 9)), int(rng.integers(0, 9))), (0, 0),
                           (10**6, 10**6), (2**32, 3)]:
                t, j = both(sizes, f_t, ff, df, F, D)
                assert t == j, (n, ff, df)
                # the loop under the float32 thresholds, with the pool as given
                assert t == loop(sizes, f_t, ff, df, f32(F), f32(D)), (n, ff, df)
                cases += 1
    assert cases > 100


@pytest.mark.parametrize("F,D", THRESHOLDS[1:], ids=["D_not", "F_D_not"])
def test_unrepresentable_thresholds_compare_in_float32(F, D):
    """At the float32 neighbours of D (and of F) the loop under the
    unrounded threshold decides otherwise than under it rounded to float32;
    both vectorized placers take the float32 side, as JAX's weak typing
    does."""
    sizes = neighbours(D) * 3
    t, j = both(sizes, 1e4, 1, 1, F, D)              # a burst: small payloads go serverless
    assert t == j == loop(sizes, 1e4, 1, 1, f32(F), f32(D))
    assert t != loop(sizes, 1e4, 1, 1, F, D)
    rates = np.array(neighbours(F) * 2, np.float32)
    t, j = both([f32(D) / 2] * len(rates), rates, 8, 8, F, D)
    assert t == j == loop([f32(D) / 2] * len(rates), rates, 8, 8, f32(F), f32(D))
    if f32(F) != F:
        assert t != loop([f32(D) / 2] * len(rates), rates, 8, 8, F, D)


def test_availability_as_0d_tensors_and_float64_rates():
    """Availability as 0-d int tensors on the sizes' device, and a float64
    rate vector, which is cast to float32 as JAX's ``asarray`` casts it."""
    rng = np.random.default_rng(7)
    sizes = np.asarray(rng.lognormal(np.log(1e6), 1.0, 500), np.float32)
    rates = rng.choice(np.array([1199.99999999, 1200.0, 1200.00001, 5.0]), 500)
    for ff, df in [(0, 0), (3, 5), (8, 8), (400, 400)]:
        t = placing_batch_torch(torch.from_numpy(rates), torch.from_numpy(sizes),
                                torch.tensor(ff, dtype=torch.int32), torch.tensor(df),
                                F=1200.0, D=1e6)
        j = placing_batch_jax(jnp.asarray(rates, jnp.float32), jnp.asarray(sizes),
                              jnp.int32(ff), jnp.int32(df), F=1200.0, D=1e6)
        assert t.tolist() == np.asarray(j).tolist()
        assert t.tolist() == loop([float(s) for s in sizes], rates.astype(np.float32), ff, df,
                                  1200.0, 1e6)


def test_every_branch_of_algorithm_1_is_taken():
    """The paper's lines 3, 6, 10, 14 and 18 in one batch, availability
    consumed in arrival order, large payloads consuming docker slots too."""
    sizes = [1e5, 5e6, 1e5, 1e5, 1e5, 1e5]
    t, j = both(sizes, 100.0, 2, 2, 1000.0, 1e6)
    assert t == j == [Tier.FLASK, Tier.DOCKER, Tier.FLASK, Tier.DOCKER, Tier.SERVERLESS,
                      Tier.SERVERLESS]
    t, _ = both(sizes, 2000.0, 2, 2, 1000.0, 1e6)
    assert t == [Tier.SERVERLESS, Tier.DOCKER] + [Tier.SERVERLESS] * 4
