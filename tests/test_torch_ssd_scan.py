"""The port's SSD scan on the CPU (its plain version) against the JAX
package's oracle and its Pallas kernel in interpret mode.

``repro_torch.kernels.ssd_scan.ops.ssd_scan`` runs the plain PyTorch
version for CPU tensors; here it is held against the reference's
``ssd_reference`` and its Pallas ``ssd_scan`` (interpret mode on the
CPU), over the sweep of ``tests/test_kernels.py`` plus a second ragged
length and a path-shaped case (G=1, P=64, N=Q=128), in float32 and
bfloat16. Tolerances: 1e-5 of the output scale in float32 (the chunked
sums run in another order), 1e-2 in bfloat16 (one rounding of y to
bfloat16, 2**-8 of an element). Also: the literal recurrence, the
one-token ``ssd_decode_step`` against the reference's and against the
chunked form, the ``intra_dtype`` rule of ROADMAP C4, and the wrapper's
input checks; that the reference, cut into the kernel's three plain
passes, gives the bits it gave as one function; the route rule of the
kernel's passes; and that the split probes of ``chip_smoke.py`` tell
float32 operands from bfloat16 ones. The CUDA kernel is held against the
same plain version on the card (``tests/test_torch_ssd_scan_gpu.py``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_decode_step as jax_decode_step
from repro.kernels.ssd_scan.ref import ssd_reference as jax_reference
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ops import (
    kernel_route, ssd_scan, ssd_scan_plain,
)
from repro_torch.kernels.ssd_scan.ref import (
    NEG_INF, ssd_decode_step, ssd_reference,
)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# (b, l, h, g, p, n, chunk): tests/test_kernels.py's sweep, a ragged length
# with groups, jamba's N = 16 at chunk 128 (ragged, G=2), and mamba2-2.7b's
# head shape (G=1, P=64, N=Q=128) at 8 heads
SWEEP = [
    (2, 64, 4, 1, 16, 8, 16),
    (1, 96, 8, 2, 32, 16, 32),
    (2, 50, 4, 1, 16, 8, 16),      # L not a multiple of the chunk
    (1, 128, 4, 4, 64, 32, 64),    # groups == heads
    (1, 100, 4, 2, 16, 8, 32),     # L not a multiple of the chunk, G=2
    (2, 300, 8, 2, 64, 16, 128),   # jamba's N = 16 at chunk 128, ragged
    (1, 200, 8, 1, 64, 128, 128),  # path-shaped: G=1, H=8, ragged
]


def _inputs(b, l, h, g, p, n, dtype="float32", seed=0):
    """Seeded (x, dt, a, b_mat, c_mat) as (jax tuple, torch tuple) with
    identical values; x, b_mat and c_mat in ``dtype``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (np.abs(rng.standard_normal((b, l, h)) * 0.5) + 0.01).astype(
        np.float32)
    a = (-np.abs(rng.standard_normal(h)) - 0.1).astype(np.float32)
    bm = (rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, l, g, n)) * 0.3).astype(np.float32)
    jd, td = DT[dtype]
    jx, jb, jc = (jnp.asarray(v, jd) for v in (x, bm, cm))
    tx, tb, tc = (torch.from_numpy(np.array(v.astype(jnp.float32))).to(td)
                  for v in (jx, jb, jc))
    return ((jx, jnp.asarray(dt), jnp.asarray(a), jb, jc),
            (tx, torch.from_numpy(dt), torch.from_numpy(a), tb, tc))


def _assert_close(got, want, tol):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("oracle", ["reference", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,g,p,n,chunk", SWEEP)
def test_plain_ssd_scan_matches_the_reference(b, l, h, g, p, n, chunk, dtype,
                                              oracle):
    jargs, targs = _inputs(b, l, h, g, p, n, dtype)
    if oracle == "reference":
        want = jax_reference(*jargs, chunk=chunk)
    else:
        want = jax_ssd_scan(*jargs, chunk=chunk)     # interpret mode on the CPU
    before = ssd_scan.launches
    got = ssd_scan(*targs, chunk=chunk)
    assert ssd_scan.launches == before == 0
    assert got.dtype == DT[dtype][1] and got.shape == (b, l, h, p)
    _assert_close(got, want, TOL[dtype])


@pytest.mark.parametrize("l,chunk", [(32, 16), (45, 16)])
def test_plain_ssd_scan_equals_naive_recurrence(l, chunk):
    """The chunked dual form equals the literal SSM recurrence (the check
    of ``tests/test_kernels.py``, and a ragged length)."""
    b, h, p, n = 1, 2, 8, 4
    _, (x, dt, a, bm, cm) = _inputs(b, l, h, 1, p, n)
    out = ssd_scan(x, dt, a, bm, cm, chunk=chunk).numpy()
    x, dt, a, bm, cm = (v.numpy().astype(np.float64)
                        for v in (x, dt, a, bm, cm))
    state = np.zeros((b, h, n, p))
    ys = []
    for t in range(l):
        decay = np.exp(dt[:, t] * a)
        bt = np.repeat(bm[:, t], h, axis=1)
        ct = np.repeat(cm[:, t], h, axis=1)
        state = decay[..., None, None] * state + np.einsum(
            "bh,bhn,bhp->bhnp", dt[:, t], bt, x[:, t])
        ys.append(np.einsum("bhn,bhnp->bhp", ct, state))
    np.testing.assert_allclose(out, np.stack(ys, axis=1), atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,g", [(4, 1), (8, 2), (80, 1)])
def test_decode_step_matches_the_reference(h, g, dtype):
    rng = np.random.default_rng(h + g)
    b, p, n = 3, 16, 8
    (jx, jdt, ja, jb, jc), (tx, tdt, ta, tb, tc) = _inputs(
        b, 1, h, g, p, n, dtype, seed=h)
    state = rng.standard_normal((b, h, n, p)).astype(np.float32)
    jy, js = jax_decode_step(jnp.asarray(state), jx[:, 0], jdt[:, 0], ja,
                             jb[:, 0], jc[:, 0])
    ty, ts = ssd_decode_step(torch.from_numpy(state), tx[:, 0], tdt[:, 0],
                             ta, tb[:, 0], tc[:, 0])
    assert ty.dtype == DT[dtype][1] and ts.dtype == torch.float32
    _assert_close(ty, jy, TOL[dtype])
    _assert_close(ts, js, 1e-6)


@pytest.mark.parametrize("l,chunk", [(64, 16), (50, 16), (40, 64)])
def test_chunked_form_equals_steps_of_the_recurrence(l, chunk):
    """The port's chunked scan against L steps of its own
    ``ssd_decode_step`` from a zero state (float32; 1e-5 of the scale)."""
    b, h, g, p, n = 2, 4, 2, 16, 8
    _, (x, dt, a, bm, cm) = _inputs(b, l, h, g, p, n, seed=3)
    want = ssd_scan(x, dt, a, bm, cm, chunk=chunk)
    state = torch.zeros((b, h, n, p))
    ys = []
    for t in range(l):
        y_t, state = ssd_decode_step(state, x[:, t], dt[:, t], a, bm[:, t],
                                     cm[:, t])
        ys.append(y_t)
    _assert_close(torch.stack(ys, dim=1), want.numpy(), 1e-5)


@pytest.mark.parametrize("b,l,h,g,p,n,chunk", [SWEEP[0], SWEEP[-1]])
def test_intra_dtype_bfloat16_follows_the_kernel_contract(b, l, h, g, p, n,
                                                          chunk):
    """ROADMAP C4: the reference's ``ssd_reference(intra_dtype=bfloat16)``
    rounds the decay, the scores, dt and x before the intra-chunk product;
    its Pallas kernel keeps them in float32. The port's scan (and its
    kernel) follows the Pallas kernel, whatever ``ssd_intra_dtype`` says;
    its twin of the oracle still reproduces the rounded path."""
    jargs, targs = _inputs(b, l, h, g, p, n)
    kernel = jax_ssd_scan(*jargs, chunk=chunk)
    rounded = jax_reference(*jargs, chunk=chunk, intra_dtype=jnp.bfloat16)
    port = ssd_scan(*targs, chunk=chunk)
    _assert_close(port, kernel, TOL["float32"])
    # the rounded path is measurably another function (0.6-0.9% of the
    # output scale on these inputs) ...
    k = np.asarray(kernel)
    assert np.abs(np.asarray(rounded) - k).max() / np.abs(k).max() > 1e-3
    # ... which the port's twin of the oracle reproduces, up to bfloat16
    # rounding of the einsums' outputs in the two frameworks
    twin = ssd_reference(*targs, chunk=chunk, intra_dtype=torch.bfloat16)
    _assert_close(twin, rounded, 1e-3)


def test_ssd_scan_reads_strided_views():
    """In the model x, B and C are column slices of the conv output; the
    wrapper takes the views as they are and gives the contiguous result."""
    b, l, h, g, p, n = 2, 40, 4, 1, 16, 8
    rng = np.random.default_rng(5)
    xbc = torch.from_numpy(rng.standard_normal(
        (b, l, h * p + 2 * g * n)).astype(np.float32))
    x = xbc[..., :h * p].reshape(b, l, h, p)
    bm = xbc[..., h * p:h * p + g * n].reshape(b, l, g, n)
    cm = xbc[..., h * p + g * n:].reshape(b, l, g, n)
    assert not x.is_contiguous() and x.data_ptr() == xbc.data_ptr()
    _, (_, dt, a, _, _) = _inputs(b, l, h, g, p, n)
    got = ssd_scan(x, dt, a, bm, cm, chunk=16)
    want = ssd_scan_plain(x.contiguous(), dt, a, bm.contiguous(),
                          cm.contiguous(), chunk=16)
    assert torch.equal(got, want)


def _bad_inputs():
    _, (x, dt, a, bm, cm) = _inputs(1, 16, 4, 2, 8, 4)
    return [
        ("dtype", (x.double(), dt, a, bm, cm), TypeError),
        ("b dtype", (x, dt, a, bm.bfloat16(), cm), TypeError),
        ("dt dtype", (x, dt.bfloat16(), a, bm, cm), TypeError),
        ("a shape", (x, dt, a[:3], bm, cm), ValueError),
        ("dt shape", (x, dt[:, :8], a, bm, cm), ValueError),
        ("groups", (x, dt, a, bm[:, :, :1].expand(1, 16, 3, 4),
                    cm[:, :, :1].expand(1, 16, 3, 4)), ValueError),
        ("c shape", (x, dt, a, bm, cm[:, :8]), ValueError),
        ("x rank", (x[0], dt, a, bm, cm), ValueError),
        ("meta device", tuple(t.to("meta") for t in (x, dt, a, bm, cm)),
         ValueError),
    ]


@pytest.mark.parametrize("case", range(len(_bad_inputs())))
def test_ssd_scan_rejects_what_it_does_not_take(case):
    name, args, err = _bad_inputs()[case]
    before = ssd_scan.launches
    with pytest.raises(err):
        ssd_scan(*args, chunk=8)
    assert ssd_scan.launches == before, name


def test_build_report_tells_a_reused_library_from_a_built_one():
    """``chip_smoke.py`` reports a library that ``kernels.build`` reused
    from ``build/`` as such, not as one with no entry points."""
    import importlib.util
    import sys
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = smoke         # its dataclass looks itself up
    try:
        spec.loader.exec_module(smoke)
    finally:
        del sys.modules[spec.name]
    assert smoke.build_report("ssd_scan", None) == (
        "[build] ssd_scan: reused from build/ (no ptxas log)")
    log = ("ptxas info    : Used 128 registers, used 1 barriers\n"
           "ptxas info    : Used 96 registers, used 1 barriers\n"
           "ptxas info    :     0 bytes spill stores, 0 bytes spill loads\n")
    assert smoke.build_report("ssd_scan", log) == (
        "[build] ssd_scan: 2 entry points, registers 96-128, no spills")


def test_ptxas_report_names_each_kernel_of_the_ssd_library():
    """``chip_smoke.py`` names each kernel of the SSD-scan library from its
    mangled name, and reads registers, spills and the wgmma waits ptxas
    injected from ``ptxas -v``; a note that mentions registers is not a
    register count."""
    smoke = _smoke()
    pre = "_ZN44_GLOBAL__N__184f87bf_11_ssd_scan_cu_b298bcfa"
    names = {pre + "2tc13chunk_outputsILi128ELi2EEEvNS_4ArgsE":
             "tc::chunk_outputs<128,2>",
             pre + "2tc12chunk_statesILi64EEEvNS_4ArgsE":
             "tc::chunk_states<64>",
             pre + "4simt13chunk_outputsI13__nv_bfloat16EEvNS_4ArgsE":
             "simt::chunk_outputs<bf16>",
             pre + "4simt12chunk_statesIfEEvNS_4ArgsE":
             "simt::chunk_states<f32>",
             pre + "13state_passingILi4EEEvPfPKfiii": "state_passing<4>"}
    for mangled, label in names.items():
        assert smoke.kernel_label(mangled) == label
    tc = pre + "2tc13chunk_outputsILi128ELi2EEEvNS_4ArgsE"
    log = (f"ptxas info    : (C7517) warpgroup.wait is injected in around "
           f"line 9 by compiler to allow use of registers defined by GMMA in "
           f"function '{tc}'\n"
           f"ptxas info    : Compiling entry function '{tc}' for 'sm_90a'\n"
           f"    16 bytes stack frame, 16 bytes spill stores, 16 bytes spill "
           f"loads\n"
           f"ptxas info    : Used 128 registers, used 1 barriers\n")
    assert smoke.ptxas_by_kernel(log) == {
        "tc::chunk_outputs<128,2>": "128 registers, 16 bytes spill stores, "
                                    "16 bytes spill loads; injected wgmma "
                                    "1 waits"}
    assert smoke.build_report("ssd_scan", log).startswith(
        "[build] ssd_scan: 1 entry points, registers 128-128; spills")


# --- the three plain passes -------------------------------------------------

def _ssd_reference_before_the_split(
    x: torch.Tensor,       # (B, L, H, P)  inputs per head
    dt: torch.Tensor,      # (B, L, H)     positive step sizes
    a: torch.Tensor,       # (H,)          negative decay rates (A = -exp(A_log))
    b_mat: torch.Tensor,   # (B, L, G, N)  input projections (G groups)
    c_mat: torch.Tensor,   # (B, L, G, N)  output projections
    chunk: int = 128,
    intra_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``ref.ssd_reference`` as it was before it was cut into three
    passes, op for op (the pin below holds the cut version to it)."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if l % chunk != 0:
        pad = chunk - l % chunk
        y = _ssd_reference_before_the_split(
            torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)),
            torch.nn.functional.pad(dt, (0, 0, 0, pad)),
            a,
            torch.nn.functional.pad(b_mat, (0, 0, 0, 0, 0, pad)),
            torch.nn.functional.pad(c_mat, (0, 0, 0, 0, 0, pad)),
            chunk,
            intra_dtype,
        )
        return y[:, :l]
    nc, q = l // chunk, chunk
    rep = h // g

    f32 = torch.float32
    x_ = x.reshape(bsz, nc, q, h, p).to(f32)
    dt_ = dt.reshape(bsz, nc, q, h).to(f32)
    b_ = b_mat.reshape(bsz, nc, q, g, n).to(f32)
    c_ = c_mat.reshape(bsz, nc, q, g, n).to(f32)

    da = dt_ * a.to(f32)                           # (b,nc,q,h), negative
    cs = torch.cumsum(da, dim=2)                   # within-chunk cumulative decay

    # intra-chunk (dual quadratic form): decay(i,j) = exp(cs_i - cs_j), i >= j
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # (b,nc,qi,qj,h)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    seg = torch.where(mask[None, None, :, :, None], seg,
                      torch.tensor(NEG_INF, dtype=f32, device=x.device))
    decay = torch.exp(seg).to(intra_dtype)

    cb = torch.einsum("bcign,bcjgn->bcijg", c_, b_).to(intra_dtype)
    cb = torch.repeat_interleave(cb, rep, dim=-1)              # (b,nc,qi,qj,h)
    att = cb * decay * dt_[:, :, None, :, :].to(intra_dtype)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att,
                           x_.to(intra_dtype)).to(f32)

    # chunk summary states: sum_j exp(cs_last - cs_j) dt_j B_j x_j^T
    last = cs[:, :, -1:, :]                                    # (b,nc,1,h)
    w = torch.exp(last - cs) * dt_                             # (b,nc,q,h)
    b_exp = torch.repeat_interleave(b_, rep, dim=3)            # (b,nc,q,h,n)
    state = torch.einsum("bcqh,bcqhn,bcqhp->bchnp", w, b_exp, x_)

    # inter-chunk recurrence S_c = exp(sum da_c) S_{c-1} + state_c; each
    # chunk reads the state from before it
    chunk_decay = torch.exp(cs[:, :, -1, :])                   # (b,nc,h)
    s = torch.zeros((bsz, h, n, p), dtype=f32, device=x.device)
    before = []
    for c in range(nc):
        before.append(s)
        s = chunk_decay[:, c, :, None, None] * s + state[:, c]
    s_before = torch.stack(before, dim=1)                      # (b,nc,h,n,p)

    # inter-chunk contribution y_i += exp(cs_i) C_i . S_before
    c_exp = torch.repeat_interleave(c_, rep, dim=3)            # (b,nc,q,h,n)
    y_inter = torch.einsum("bcqh,bcqhn,bchnp->bcqhp", torch.exp(cs), c_exp,
                           s_before)

    y = (y_intra + y_inter).reshape(bsz, l, h, p)
    return y.to(x.dtype)



@pytest.mark.parametrize("intra", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,g,p,n,chunk", SWEEP)
def test_reference_is_bit_for_bit_what_it_was(b, l, h, g, p, n, chunk, dtype,
                                              intra):
    """``ssd_reference``, now composed of ``ssd_chunk_states``,
    ``ssd_state_passing`` and ``ssd_chunk_outputs``, gives exactly the bits
    of the single function it was (the same ops in the same order)."""
    _, targs = _inputs(b, l, h, g, p, n, dtype, seed=l + h)
    intra_dtype = DT[intra][1]
    got = ssd_reference(*targs, chunk=chunk, intra_dtype=intra_dtype)
    want = _ssd_reference_before_the_split(*targs, chunk=chunk,
                                           intra_dtype=intra_dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("b,l,h,g,p,n,chunk", [SWEEP[0], SWEEP[2], SWEEP[4]])
def test_pass_wrappers_on_the_cpu_compose_the_scan(b, l, h, g, p, n, chunk):
    """``ops.chunk_states``, ``ops.state_passing`` and ``ops.chunk_outputs``
    (the kernel's passes one at a time) run the plain passes on the CPU,
    ragged L padded as the scan pads it, and compose to ``ssd_scan``."""
    _, (x, dt, a, bm, cm) = _inputs(b, l, h, g, p, n, seed=11)
    states, decay = ssd_ops.chunk_states(x, dt, a, bm, chunk=chunk)
    nc = -(-l // chunk)
    assert states.shape == (b, nc, h, n, p) and decay.shape == (b, nc, h)
    before = ssd_ops.state_passing(states, decay)
    assert before.shape == states.shape
    assert torch.equal(before[:, 0], torch.zeros_like(before[:, 0]))
    y = ssd_ops.chunk_outputs(x, dt, a, bm, cm, before, chunk=chunk)
    assert torch.equal(y, ssd_scan(x, dt, a, bm, cm, chunk=chunk))
    with pytest.raises(ValueError):
        ssd_ops.chunk_outputs(x, dt, a, bm, cm, before[:, :, :1], chunk=chunk)
    with pytest.raises(ValueError):
        ssd_ops.state_passing(states, decay[:, :1])


@pytest.mark.parametrize("dtype,chunk,n,p,route", [
    (torch.bfloat16, 128, 128, 64, "tensor_cores"),   # mamba2-2.7b's path
    (torch.bfloat16, 64, 128, 64, "tensor_cores"),
    (torch.bfloat16, 64, 32, 64, "tensor_cores"),
    (torch.bfloat16, 128, 64, 16, "tensor_cores"),
    (torch.bfloat16, 128, 16, 64, "tensor_cores"),   # jamba-v0.1-52b's path
    (torch.bfloat16, 32, 128, 64, "cuda_cores"),     # Q < 64
    (torch.bfloat16, 16, 8, 16, "cuda_cores"),
    (torch.bfloat16, 100, 128, 64, "cuda_cores"),    # Q not a tile size
    (torch.bfloat16, 128, 8, 64, "cuda_cores"),      # N not a multiple of 16
    (torch.bfloat16, 128, 128, 8, "cuda_cores"),     # P not a multiple of 16
    (torch.float32, 128, 128, 64, "cuda_cores"),     # float32: CUDA cores
])
def test_kernel_route_is_a_function_of_dtype_chunk_n_p(dtype, chunk, n, p,
                                                       route):
    assert kernel_route(dtype, chunk, n, p) == route


def test_mamba2_prefill_takes_the_tensor_core_route():
    """The path's shape in its serving dtype: bfloat16, Q = N = 128,
    P = 64."""
    from repro_torch.configs.mamba2_2_7b import CONFIG
    assert CONFIG.dtype == "bfloat16"
    assert kernel_route(torch.bfloat16, CONFIG.ssm_chunk, CONFIG.ssm_state,
                        CONFIG.ssm_headdim) == "tensor_cores"


def test_jamba_prefill_takes_the_tensor_core_route():
    """jamba-v0.1-52b's Mamba2 layers in bfloat16: Q = 128, N = 16,
    P = 64, one 64-column box of B and C whose last 48 columns are zero
    fill."""
    from repro_torch.configs.jamba_v0_1_52b import CONFIG
    assert (CONFIG.dtype, CONFIG.ssm_chunk, CONFIG.ssm_state,
            CONFIG.ssm_headdim) == ("bfloat16", 128, 16, 64)
    assert kernel_route(torch.bfloat16, CONFIG.ssm_chunk, CONFIG.ssm_state,
                        CONFIG.ssm_headdim) == "tensor_cores"


@functools.cache
def _smoke():
    """``chip_smoke.py``, for its split probes."""
    import importlib.util
    import sys
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = smoke         # its dataclass looks itself up
    try:
        spec.loader.exec_module(smoke)
    finally:
        del sys.modules[spec.name]
    return smoke


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("kind", ["scores", "states", "s_before"])
def test_split_probe_tells_float32_from_bfloat16_operands(kind, chunk):
    """On the CPU the wrapper runs the plain version, whose operands are
    float32: it meets each split probe's bound, and the output that the
    probed operand rounded to bfloat16 gives does not (by far)."""
    smoke = _smoke()
    args, rows, exact, rounded = smoke.ssd_probe(kind, chunk, "cpu")
    y = ssd_scan(*args, chunk=chunk)
    assert y.dtype == torch.bfloat16 and y.shape == args[0].shape
    assert smoke.ssd_split_err(y, rows, exact) <= smoke.SSD_SPLIT_TOL
    off = ((rounded - exact)[rows].abs() / exact[rows].abs()).max().item()
    assert off > 10 * smoke.SSD_SPLIT_TOL
