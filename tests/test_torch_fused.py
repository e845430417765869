"""The port's fused measure/apply pair and four-step FFT against the JAX
package's ``FusedPipelineKernels`` (Pallas, interpret mode on the CPU), on
the same bytes. On CPU tensors the port runs its plain versions; the
CUDA kernels are held to those on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Bars, and why:
  * measure scalars, where the pipeline uses the measurement (mag >= 0.1):
    lag atol 1e-3 samples; z, mag, papr rtol 1e-3. The arctangent differs
    (the JAX kernel's polynomial is within 3e-6 rad) and float32 sums run
    in other orders; see _assert_measure_close for uncorrelated bytes.
  * D: under 1e-3 of the elements more than 1 bf16 ulp apart - summation
    order can flip the bf16 rounding of an element of C = bf16(B * T).
  * wire bytes: max |diff| <= 2 LSB and under 1e-3 of them > 1 LSB, the
    reference's own bars (tests/test_kernels.py:443-450).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coherent_rtlsdr_tpu.kernels.fft4step import FFT4Step as JaxFFT4Step
from coherent_rtlsdr_tpu.kernels.pallas_fused import FusedPipelineKernels as JaxKernels
from coherent_rtlsdr_tpu_torch.kernels import fused_cuda
from coherent_rtlsdr_tpu_torch.kernels.fft4step import FFT4Step
from coherent_rtlsdr_tpu_torch.kernels.fourstep import FFT4StepKernel
from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels, get_fused_kernels

W = 4096
M = 64
T, N = 4, 3
MIN_CORR_MAG = 0.1   # PipelineConfig.min_corr_mag


def _stream_bytes(kind, seed, m=M, t=T, n_ch=N):
    """Signed blocks ``raw [t, n_ch, m/2, 2m]`` and ``ref_raw [t, m/2,
    2m]``: uniform random bytes, or channels that are fractionally delayed,
    rotated, noisy copies of a Gaussian reference (made with numpy)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (rng.integers(-128, 128, (t, n_ch, m // 2, 2 * m), dtype=np.int8),
                rng.integers(-128, 128, (t, m // 2, 2 * m), dtype=np.int8))
    n = t * m * m // 2
    ref = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.25
    f = np.fft.fftfreq(n)
    delays = rng.uniform(-30, 30, n_ch)
    rot = np.exp(1j * rng.uniform(-np.pi, np.pi, n_ch))
    sig = np.fft.ifft(np.fft.fft(ref)[None] * np.exp(-2j * np.pi * f[None] * delays[:, None]))
    sig = sig * rot[:, None] + 0.01 * (rng.standard_normal((n_ch, n))
                                       + 1j * rng.standard_normal((n_ch, n)))

    def q(x):
        iq = np.stack([x.real, x.imag], -1) * 127.0
        return np.clip(np.round(iq), -128, 127).astype(np.int8)

    return (q(sig).reshape(n_ch, t, m // 2, 2 * m).transpose(1, 0, 2, 3).copy(),
            q(ref).reshape(t, m // 2, 2 * m))


def _bf16_bits(x):
    return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16).view(torch.int16).numpy()


def _ulp_apart(a, b):
    return np.abs(_bf16_bits(a).astype(np.int32) - _bf16_bits(b).astype(np.int32))


def _assert_measure_close(got, want):
    """The measure bars. Lag, z, mag and papr are held where the pipeline
    uses the measurement (mag >= min_corr_mag): on uncorrelated bytes the
    phase-zoom sums nearly cancel and summation order alone can move the
    lag by tenths of a sample (seen between the CUDA kernel and the plain
    version on the H100). Everywhere: the same accept/reject decision,
    finite values, and the stored spectra D."""
    for x in got[:5]:
        assert np.isfinite(x).all()
    used = want[3] >= MIN_CORR_MAG
    np.testing.assert_array_equal(got[3] >= MIN_CORR_MAG, used)
    np.testing.assert_allclose(got[0][used], want[0][used], atol=1e-3)
    for name, a, b in zip(("z_re", "z_im", "mag", "papr"), got[1:5], want[1:5]):
        np.testing.assert_allclose(a[used], b[used], rtol=1e-3, err_msg=name)
    for a, b in zip(got[5:], want[5:]):
        assert (_ulp_apart(a, b) > 1).mean() < 1e-3


def _assert_wire_close(a, b):
    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    assert d.max() <= 2, d.max()
    assert (d > 1).mean() < 1e-3, (d > 1).mean()


@pytest.fixture(scope="module")
def jax_kernels():
    return JaxKernels(W)


@pytest.fixture(scope="module")
def jax_measure(jax_kernels):
    return jax.jit(jax_kernels.measure_i8_spec)


@pytest.mark.parametrize("kind", ["random", "correlated"])
def test_measure_matches_jax(kind, jax_measure):
    raw, ref_raw = _stream_bytes(kind, seed=11)
    j = [np.asarray(x.astype(jnp.float32)) for x in jax_measure(jnp.asarray(raw),
                                                                  jnp.asarray(ref_raw))]
    k = FusedPipelineKernels(W, "cpu")
    t = [x.float().numpy() for x in k.measure_i8_spec(torch.from_numpy(raw),
                                                      torch.from_numpy(ref_raw))]
    assert k.counts() == dict.fromkeys(k.counts(), 0) | dict(measure_ref_plain_runs=1,
                                                            measure_spec_plain_runs=1)
    assert t[0].shape == (T - 1, N) and t[5].shape == (T - 1, N, M, M)
    _assert_measure_close(t, j)
    used = j[3] >= MIN_CORR_MAG
    assert used.all() if kind == "correlated" else not used.any(), j[3]


@pytest.mark.parametrize("kind", ["random", "correlated"])
def test_apply_matches_jax(kind, jax_kernels, jax_measure):
    raw, ref_raw = _stream_bytes(kind, seed=12)
    rng = np.random.default_rng(13)
    adv = rng.uniform(-40, 40, (T - 1, N)).astype(np.float32)
    adv[0, 0] = -1500.25   # a large integer part of either sign
    adv[0, 1] = 1023.5
    ph = np.exp(1j * rng.uniform(-np.pi, np.pi, (T - 1, N)))
    pre, pim = ph.real.astype(np.float32), ph.imag.astype(np.float32)
    # Apply gets JAX's own D, so the comparison isolates it.
    jd = jax_measure(jnp.asarray(raw), jnp.asarray(ref_raw))
    wj = jax.jit(jax_kernels.apply_spec_i8)(jd[5], jd[6], jnp.asarray(adv),
                                            jnp.asarray(pre), jnp.asarray(pim))
    d = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
         for x in jd[5:]]
    k = FusedPipelineKernels(W, "cpu")
    wt = k.apply_spec_i8(*d, torch.from_numpy(adv), torch.from_numpy(pre), torch.from_numpy(pim))
    assert (k.apply_spec_i8_plain_runs, k.apply_spec_i8_launches) == (1, 0)
    assert wt.dtype == torch.int8 and tuple(wt.shape) == (T - 1, N, M // 2, 2 * M)
    _assert_wire_close(wt.numpy(), np.asarray(wj))


def test_fft4step_matches_jax():
    rng = np.random.default_rng(14)
    x = ((rng.standard_normal((2, W)) + 1j * rng.standard_normal((2, W))) * 0.3).astype(np.complex64)
    jf, tf = JaxFFT4Step(W), FFT4Step(W, "cpu")
    Xj = np.array(jf.fft(jnp.asarray(x)))
    Xt = tf.fft(torch.from_numpy(x)).numpy()
    assert Xt.shape == (2, M, M)
    rms = np.sqrt(np.mean(np.abs(Xj) ** 2))
    # Same bf16 casts on both sides; only float32 summation order differs
    # (and the rare bf16 flip of C it causes).
    assert np.abs(Xt - Xj).max() / rms < 1e-3
    xj = np.array(jf.ifft(jnp.asarray(Xj)))
    xt = tf.ifft(torch.from_numpy(Xj)).numpy()
    assert np.abs(xt - xj).max() / np.sqrt(np.mean(np.abs(xj) ** 2)) < 1e-3
    # And the pair inverts to bf16 accuracy.
    assert np.abs(xt - x).max() / np.sqrt(np.mean(np.abs(x) ** 2)) < 2e-2


def test_get_fused_kernels_is_one_instance_per_device():
    a = get_fused_kernels(W, "cpu")
    assert get_fused_kernels(W, torch.device("cpu")) is a
    assert get_fused_kernels(4 * W, "cpu") is not a


def test_cuda_wrapper_rejects_unsupported_sizes():
    # m = 32 and m = 512 have plain versions but no CUDA kernel: every
    # wrapper refuses both before touching a device. m = 256 is admitted by
    # every entry (its cluster kernels), so a CPU tensor there gets past the
    # size check to the device check.
    for m in (32, 512):
        k = FusedPipelineKernels(m * m, "cpu")
        raw = torch.zeros((2, 1, m // 2, 2 * m), dtype=torch.int8)
        one = torch.zeros((1, 1))
        d = torch.zeros((1, 1, m, m), dtype=torch.bfloat16)
        planes = torch.zeros((2, 1, m // 2, m), dtype=torch.bfloat16)
        calls = [lambda: fused_cuda.measure_ref(k, raw[:, 0]),
                 lambda: fused_cuda.measure_spec(k, raw, *k.measure_ref_plain(raw[:, 0])),
                 lambda: fused_cuda.measure_i8(k, raw, *k.measure_ref_plain(raw[:, 0])),
                 lambda: fused_cuda.apply_spec_i8(k, d, d, one, one, one),
                 lambda: fused_cuda.apply_i8(k, raw, one, one, one),
                 lambda: fused_cuda.measure_planes(k, planes, planes, d[0], d[0]),
                 lambda: fused_cuda.apply_planes(k, planes, planes, one),
                 lambda: fused_cuda.fourstep(FFT4StepKernel(m * m, "cpu"),
                                             torch.zeros((1, m, m), dtype=torch.complex64),
                                             False)]
        for call in calls:
            with pytest.raises(ValueError, match=f"m in \\(64, 128, 256\\), got m = {m}"):
                call()
        assert not any(v for name, v in k.counts().items() if name.endswith("_launches"))
    k = FusedPipelineKernels(65536, "cpu")
    planes = torch.zeros((2, 1, 128, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="kernels built for cpu"):
        fused_cuda.apply_planes(k, planes.to("meta"), planes.to("meta"), torch.zeros((1, 1)))
    with pytest.raises(ValueError):
        FusedPipelineKernels(4000, "cpu")


def test_cuda_admission_is_per_entry():
    """Each C entry point takes m in {64, 128, 256} (at m = 256 a window,
    or a transform, on a cluster of four CTAs) and refuses any other m.
    The ptxas check covers every tensor-core instantiation, the seven
    m = 256 cluster kernels among them."""
    assert fused_cuda.ADMITTED_M == dict.fromkeys(
        ["fused_measure_ref", "fused_measure_i8_spec", "fused_measure_i8",
         "fused_apply_spec_i8", "fused_apply_i8", "fourstep_fft", "fused_measure_planes",
         "fused_apply_planes"], (64, 128, 256))
    assert not hasattr(fused_cuda, "TO_PORT_AT_256")
    assert set(fused_cuda.ADMITTED_M) == {name for _, name, *_ in fused_cuda.ENTRY_POINTS
                                          if name != "probe_copy_blocks"}
    for entry, m_set in fused_cuda.ADMITTED_M.items():
        for m in m_set:
            fused_cuda.admit(entry, m)
        for m in (32, 512):
            with pytest.raises(ValueError, match=f"{entry} takes m in"):
                fused_cuda.admit(entry, m)
    names = sum(fused_cuda.TC_KERNELS.values(), ())
    assert len(names) == len(set(names)) == 27
    assert set(fused_cuda.TC_KERNELS) == set(fused_cuda.SOURCES) - {"probe_copy.cu"}
    assert {n for n in names if "cluster" in n} == {
        "fused::measure_ref_cluster_kernel", "fused::measure_cluster_kernel<1>",
        "fused::measure_cluster_kernel<0>", "fused::measure_planes_cluster_kernel",
        "fused::apply_spec_cluster_kernel", "fused::apply_i8_cluster_kernel",
        "fused::apply_planes_cluster_kernel", "fourstep::fourstep_cluster_kernel<0>",
        "fourstep::fourstep_cluster_kernel<1>"}


def test_no_fallback_without_the_card(monkeypatch, tmp_path):
    """Without nvcc the build raises; on a device that is neither CPU nor
    CUDA the dispatch raises. Nothing falls back to the plain version."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(fused_cuda, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused_cuda.build()
    k = FusedPipelineKernels(W, "cpu")
    meta = torch.empty((T, N, M // 2, 2 * M), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="meta"):
        k.measure_i8_spec(meta, meta[:, 0])
    d = torch.empty((T - 1, N, M, M), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="meta"):
        k.apply_spec_i8(d, d, *(torch.empty((T - 1, N), device="meta"),) * 3)
    planes = torch.empty((T, N, M // 2, M), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="meta"):
        k.measure(planes, planes, d[:, 0], d[:, 0])
    with pytest.raises(ValueError, match="meta"):
        k.apply(planes, planes, torch.empty((T - 1, N), device="meta"))
    assert set(k.counts().values()) == {0}
    fk = FFT4StepKernel(W, "cpu")
    x = torch.empty((2, W), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        fk.fft(x)
    with pytest.raises(ValueError, match="meta"):
        fk.ifft(x.reshape(2, M, M))
    assert set(fk.counts().values()) == {0}


# The shape of an `nvcc -Xptxas -v` report: entry kernels with and without a
# stack frame, a device function that is not an entry, and a C entry.
_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN5fused14measure_kernelILi128ELb1EEEvPKaPK6float2S4_PKfPfS8_S8_S8_S8_P13__nv_bfloat16SA_' for 'sm_90a'
ptxas info    : Function properties for _ZN5fused14measure_kernelILi128ELb1EEEvPKaPK6float2S4_PKfPfS8_S8_S8_S8_P13__nv_bfloat16SA_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 448 bytes cmem[0]
ptxas info    : Function properties for _ZN5fused9phase_zoomILi64ELi128EEENS_10ZoomResultEP6float2S3_Pf
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN5fused18measure_ref_kernelILi64EEEvPKaPK6float2S4_PS2_Pf' for 'sm_90a'
ptxas info    : Function properties for _ZN5fused18measure_ref_kernelILi64EEEvPKaPK6float2S4_PS2_Pf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5fused17apply_spec_kernelILi128EEEvPK13__nv_bfloat16S3_PKfS5_S5_PK6float2S8_Pai' for 'sm_90a'
ptxas info    : Function properties for _ZN5fused17apply_spec_kernelILi128EEEvPK13__nv_bfloat16S3_PKfS5_S5_PK6float2S8_Pai
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 154 registers, used 1 barriers, 424 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5fused15apply_i8_kernelILi64EEEvPKaPKfS4_S4_PK6float2S7_S7_Pa' for 'sm_90a'
ptxas info    : Function properties for _ZN5fused15apply_i8_kernelILi64EEEvPKaPKfS4_S4_PK6float2S7_S7_Pa
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, used 1 barriers, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5fused26measure_ref_cluster_kernelEPKaPK6float2S4_PS2_Pf' for 'sm_90a'
ptxas info    : Function properties for _ZN5fused26measure_ref_cluster_kernelEPKaPK6float2S4_PS2_Pf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 110 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN5fused22measure_cluster_kernelILb0EEEvPKaPK6float2S5_S5_PKfPfS9_S9_S9_S9_P13__nv_bfloat16SB_' for 'sm_90a'
ptxas info    : Function properties for _ZN5fused22measure_cluster_kernelILb0EEEvPKaPK6float2S5_S5_PKfPfS9_S9_S9_S9_P13__nv_bfloat16SB_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 112 registers, used 1 barriers, 448 bytes cmem[0]
ptxas info    : Compiling entry function 'probe_entry' for 'sm_90a'
ptxas info    : Function properties for probe_entry
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 10 registers, 380 bytes cmem[0]
"""


def test_ptxas_usage_reads_each_entry_kernel():
    usage = fused_cuda.ptxas_usage(_PTXAS)
    assert usage == {
        "fused::measure_kernel<128, 1>": dict(registers=168, stack=0, spill_stores=0,
                                              spill_loads=0),
        "fused::measure_ref_kernel<64>": dict(registers=96, stack=8, spill_stores=4,
                                              spill_loads=12),
        "fused::apply_spec_kernel<128>": dict(registers=154, stack=0, spill_stores=0,
                                              spill_loads=0),
        "fused::apply_i8_kernel<64>": dict(registers=122, stack=32, spill_stores=0,
                                           spill_loads=0),
        "fused::measure_ref_cluster_kernel": dict(registers=110, stack=0, spill_stores=0,
                                                  spill_loads=0),
        "fused::measure_cluster_kernel<0>": dict(registers=112, stack=0, spill_stores=0,
                                                 spill_loads=0),
        "probe_entry": dict(registers=10, stack=0, spill_stores=0, spill_loads=0),
    }
    assert len(set(fused_cuda.TC_MEASURE_KERNELS)) == 12
    assert {"fused::measure_kernel<128, 1>", "fused::measure_ref_kernel<64>",
            "fused::measure_planes_kernel<64>", "fused::measure_planes_kernel<128>"} < set(
        fused_cuda.TC_MEASURE_KERNELS)
    assert len(set(fused_cuda.TC_APPLY_KERNELS)) == 9
    assert {"fused::apply_spec_kernel<128>", "fused::apply_i8_kernel<64>",
            "fused::apply_planes_kernel<64>", "fused::apply_planes_kernel<128>"} < set(
        fused_cuda.TC_APPLY_KERNELS)
