"""K12, the COLA kick-drift in one pass (ops/cuda/cola_kick.py).

On the CPU: the plain passes against the step's fourteen passes as
``ColaEngine.step`` wrote them before K12 (copied below), bit for bit in
f32 and f64, on random states and on a COLA run's own states at 16^3;
``ColaEngine.step`` counts ``kick.plain`` and leaves x and v as those
passes do; the wrappers' refusals and the vector-path rule.  On the card
(skipped without one): the kernel bit for bit equal to the plain passes
at 256^3 and at 63^3, whose 3 N^3 elements leave a scalar tail, and on
arrays off a 16-byte boundary (the direct path).
"""
import numpy as np
import pytest
import torch

from fastbox_tpu_torch import timing
from fastbox_tpu_torch.cosmology import build_cosmology
from fastbox_tpu_torch.fields.cola import ColaEngine
from fastbox_tpu_torch.fields.gaussian import white_noise
from fastbox_tpu_torch.grid import GridSpec
from fastbox_tpu_torch.ops.cuda import _build
from fastbox_tpu_torch.ops.cuda import cola_kick as k12

COSMO = dict(Omega_c=0.25, Omega_b=0.05, h=0.7, n_s=0.95, sigma8=0.8)
DTYPES = [torch.float32, torch.float64]
L = 250.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (chip_smoke.py runs the kernel there)")
    return torch.device("cuda")


def fourteen_passes(x, v, p1, p2, F, row, fac_pm, L, dt):
    """``ColaEngine.step``'s kick and drift before K12, verbatim: ``row``
    is (K1, K2, Dr, D1, D2, dD1, dD2, a_f) in the dtype ``dt``."""
    K1, K2, Dr, D1, D2, dD1, dD2, a_f = (dt(r) for r in row)
    comp = p1 * float(D1)
    comp += p2 * float(D2 - D1 * D1)
    comp *= float(dt(fac_pm) / a_f)
    F -= comp
    del comp
    F *= float(K1 + K2)
    v += F
    del F
    x += v * float(Dr)
    x += p1 * float(dD1)
    x += p2 * float(dD2)
    torch.remainder(x, float(dt(L)), out=x)


def scalars(row, fac_pm, L, dt):
    """The kick-drift's arguments as ``ColaEngine.step`` passes them."""
    K1, K2, Dr, D1, D2, dD1, dD2, a_f = (dt(r) for r in row)
    return (float(D1), float(D2 - D1 * D1), float(dt(fac_pm) / a_f),
            float(K1 + K2), float(Dr), float(dD1), float(dD2),
            float(dt(L)))


def random_row(rng):
    """A step's scalars of the size COLA's take, and fac_pm."""
    return (tuple(rng.uniform(0.05, 2.0, 8)), float(rng.uniform(1e3, 1e4)))


def random_state(n, dtype, device, seed, offset=0):
    """(x, v, p1, p2, F), each (3, n, n, n): x in [0, L) with some
    particles next to the edges, the rest of COLA's sizes.  ``offset``
    elements into a larger buffer puts the arrays off a 16-byte boundary."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (3, n, n, n)
    out = []
    for scale in (None, 300.0, 20.0, 5.0, 3e3):
        buf = torch.empty(3 * n**3 + offset, dtype=dtype, device=device)
        t = buf[offset:].view(shape)
        if scale is None:
            t.uniform_(0.0, L, generator=g)
            t.view(-1)[:64] = L - 1e-3
            t.view(-1)[64:128] = 0.0
        else:
            t.normal_(0.0, scale, generator=g)
        out.append(t)
    return tuple(out)


@pytest.fixture(scope="module")
def engine_states():
    """A 16^3 COLA run in f32 and f64: per step, the state before it and
    the force it applies, with the step's row."""
    grid = GridSpec.create(box_scale=L, nsamp=16)
    cosmo = build_cosmology(COSMO, redshift=0.0, device="cpu")
    out = {}
    for dtype in DTYPES:
        eng = ColaEngine(grid, cosmo, redshift_init=3.0, n_steps=3,
                         dtype=dtype, device="cpu", lattice_B=3)
        white = white_noise(torch.Generator().manual_seed(3), grid, dtype,
                            "cpu")
        x, v, p1, p2 = eng.initial_conditions(white)
        steps = []
        for i in range(eng.n_steps):
            F, _ = eng.force(x, eng.rows[i][7])
            steps.append(((x.clone(), v.clone(), p1, p2, F.clone()),
                          eng.rows[i]))
            fourteen_passes(x, v, p1, p2, F, eng.rows[i], eng.fac_pm, L,
                            eng.np_dtype)
        out[dtype] = (eng, white, steps)
    return out


def _copy(t, offset=0):
    """A copy of ``t`` that starts ``offset`` elements into its buffer."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    return buf[offset:].view(t.shape).copy_(t)


def _twice(state, offset=0):
    return ([_copy(t, offset) for t in state],
            [_copy(t, offset) for t in state])


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_passes_equal_the_step_before_k12_on_random_states(dtype):
    rng = np.random.default_rng(12)
    dt = np.float32 if dtype == torch.float32 else np.float64
    for seed in range(3):
        row, fac = random_row(rng)
        a, b = _twice(random_state(8, dtype, "cpu", seed))
        fourteen_passes(*a, row, fac, L, dt)
        k12.kick_drift_plain(*b, *scalars(row, fac, L, dt))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert bool(((b[0] >= 0) & (b[0] < L)).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_passes_equal_the_step_before_k12_on_cola_states(
        engine_states, dtype):
    eng, _, steps = engine_states[dtype]
    for state, row in steps:
        a, b = _twice(state)
        fourteen_passes(*a, row, eng.fac_pm, L, eng.np_dtype)
        k12.kick_drift(*b, *scalars(row, eng.fac_pm, L, eng.np_dtype))
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert not torch.equal(a[1], state[1])   # the kick moved v


@pytest.mark.parametrize("dtype", DTYPES)
def test_engine_step_counts_plain_and_keeps_its_bits(engine_states, dtype):
    """Each step on the CPU takes the plain passes once and leaves x and v
    as the fourteen passes did; no kernel launches."""
    eng, white, steps = engine_states[dtype]
    x, v, p1, p2 = eng.initial_conditions(white)
    _build.reset_launch_counts()
    for i, (state, _) in enumerate(steps):
        assert torch.equal(x, state[0]) and torch.equal(v, state[1])
        clock = timing.StageClock("cpu")
        with timing.active(clock):
            eng.step(x, v, p1, p2, i, clock)
        counts = clock.counts()
        assert counts["kick.plain"] == 1 and "kick.fused" not in counts
        assert "update" in clock.host_ms()
    want = [t.clone() for t in steps[-1][0]]
    fourteen_passes(*want, steps[-1][1], eng.fac_pm, L, eng.np_dtype)
    assert torch.equal(x, want[0]) and torch.equal(v, want[1])
    assert _build.launch_counts() == {}


def test_plain_passes_count_only_under_a_clock():
    state = random_state(4, torch.float64, "cpu", 0)
    args = scalars(*random_row(np.random.default_rng(0)), L, np.float64)
    k12.kick_drift(*state, *args)       # no active clock: nothing counted
    clock = timing.StageClock("cpu")
    with timing.active(clock):
        k12.kick_drift(*state, *args)
        k12.kick_drift(*state, *args)
    assert clock.counts() == {"kick.plain": 2}


@pytest.mark.parametrize("fn", [k12.kick_drift, k12.kick_drift_cuda],
                         ids=["dispatch", "cuda"])
def test_wrappers_refuse_what_the_kernel_does_not_take(fn):
    args = scalars(*random_row(np.random.default_rng(1)), L, np.float32)
    x, v, p1, p2, F = random_state(4, torch.float32, "cpu", 1)
    with pytest.raises(ValueError, match="share one shape"):
        fn(x, v, p1, p2, F[:, :3], *args)
    with pytest.raises(ValueError, match=r"\(3, N, N, N\)"):
        fn(*(t[:2] for t in (x, v, p1, p2, F)), *args)
    with pytest.raises(ValueError, match=r"\(3, N, N, N\)"):
        fn(*(t.reshape(3, 16, 4) for t in (x, v, p1, p2, F)), *args)
    with pytest.raises(TypeError, match="dtype"):
        fn(x, v.double(), p1, p2, F, *args)
    with pytest.raises(TypeError, match="dtype"):
        fn(*(t.half() for t in (x, v, p1, p2, F)), *args)
    with pytest.raises(ValueError, match="contiguous"):
        fn(x, v, p1.transpose(1, 3), p2, F, *args)
    with pytest.raises(ValueError, match="share memory"):
        fn(x, x, p1, p2, F, *args)


def test_kernel_refuses_cpu_tensors():
    args = scalars(*random_row(np.random.default_rng(2)), L, np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        k12.kick_drift_cuda(*random_state(4, torch.float32, "cpu", 2), *args)
    assert _build.launch_counts().get(k12.NAME, 0) == 0


def test_vector_path_rule():
    """16-byte accesses only where every array starts on a 16-byte
    boundary; a whole-vector count is not needed (the tail is scalar)."""
    assert k12.vector_path(*random_state(3, torch.float32, "cpu", 0))
    assert not k12.vector_path(*random_state(3, torch.float32, "cpu", 0,
                                             offset=1))
    assert not k12.vector_path(*random_state(3, torch.float64, "cpu", 0,
                                             offset=1))


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(256, 0), (63, 0), (63, 1)],
                         ids=["256", "63-tail", "63-direct"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_equals_plain_passes(cuda, n, offset, dtype):
    rng = np.random.default_rng(n + offset)
    dt = np.float32 if dtype == torch.float32 else np.float64
    row, fac = random_row(rng)
    a, b = _twice(random_state(n, dtype, cuda, 7), offset)
    assert k12.vector_path(*b) == (offset == 0)
    F0 = b[4].clone()
    before = _build.launch_counts().get(k12.NAME, 0)
    k12.kick_drift(*b, *scalars(row, fac, L, dt))
    k12.kick_drift_plain(*a, *scalars(row, fac, L, dt))
    torch.cuda.synchronize()
    assert _build.launch_counts()[k12.NAME] == before + 1
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(b[4], F0)        # the kernel only reads F
