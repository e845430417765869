"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the JAX package, so on a machine without them it
runs as ``python -m pytest --noconftest tests/test_torch_cuda.py``.

Bars: lag atol 1e-3 samples and z, mag, papr rtol 1e-3 where the pipeline
uses the measurement (mag >= 0.1; on uncorrelated bytes the lag is
ill-conditioned, see PERF.md); the same accept/reject decision everywhere;
under 1e-3 of the D elements, and of the reference spectrum's elements
rounded to bf16, more than 1 bf16 ulp apart; the reference energy rtol
1e-3; wire bytes max
|diff| <= 2 LSB with under 1e-3 of them > 1 LSB.
"""

import pytest
import torch

from coherent_rtlsdr_tpu_torch.kernels.fused import FusedPipelineKernels
from coherent_rtlsdr_tpu_torch.ops.convert import u8_to_i8
from coherent_rtlsdr_tpu_torch.signal import make_truth, synth_capture

MIN_CORR_MAG = 0.1   # PipelineConfig.min_corr_mag
T, N = 3, 5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda", 0)


def _blocks(kind, m, dev):
    g = torch.Generator(device=dev).manual_seed(m)
    if kind == "random":
        return (torch.randint(-128, 128, (T, N, m // 2, 2 * m), generator=g, device=dev,
                              dtype=torch.int8),
                torch.randint(-128, 128, (T, m // 2, 2 * m), generator=g, device=dev,
                              dtype=torch.int8))
    cap = synth_capture(g, make_truth(N, seed=m, max_delay=30.0), n_blocks=T,
                        block_len=m * m // 2)
    return (u8_to_i8(cap.sig_u8.reshape(T, N, m // 2, 2 * m)),
            u8_to_i8(cap.ref_u8.reshape(T, m // 2, 2 * m)))


def _ulp_apart(a, b):
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 128])
@pytest.mark.parametrize("kind", ["random", "correlated"])
def test_kernels_match_plain_on_card(kind, m, cuda_device):
    k = FusedPipelineKernels(m * m, cuda_device)
    raw, ref_raw = _blocks(kind, m, cuda_device)
    r_got, e_got = k.measure_ref(ref_raw)
    r_want, e_want = k.measure_ref_plain(ref_raw)
    got = k.measure_spec(raw, r_got, e_got)
    want = k.measure_spec_plain(raw, r_want, e_want)
    torch.cuda.synchronize()
    assert (k.measure_ref_launches, k.measure_launches) == (1, 1)
    assert ((e_got - e_want).abs() <= 1e-3 * e_want).all()
    r_ulp = _ulp_apart(r_got.to(torch.bfloat16), r_want.to(torch.bfloat16))
    assert (r_ulp > 1).float().mean().item() < 1e-3
    for x in got[:5]:
        assert torch.isfinite(x).all()
    used = want[3] >= MIN_CORR_MAG
    assert torch.equal(got[3] >= MIN_CORR_MAG, used)
    assert used.all() if kind == "correlated" else not used.any()
    assert ((got[0] - want[0]).abs()[used] <= 1e-3).all()
    for a, b in zip(got[1:5], want[1:5]):
        assert ((a - b).abs() <= 1e-3 * b.abs())[used].all()
    for a, b in zip(got[5:], want[5:]):
        assert (_ulp_apart(a, b) > 1).float().mean().item() < 1e-3

    adv = torch.linspace(-40, 40, (T - 1) * N, device=cuda_device).reshape(T - 1, N)
    args = (want[5], want[6], adv, torch.cos(adv), torch.sin(adv))
    wk = k.apply_spec_i8(*args)
    wp = k.apply_spec_i8_plain(*args)
    torch.cuda.synchronize()
    assert k.apply_launches == 1
    d = (wk.int() - wp.int()).abs()
    assert d.max().item() <= 2 and (d > 1).float().mean().item() < 1e-3


@pytest.mark.cuda
def test_plain_versions_restore_tf32(cuda_device):
    k = FusedPipelineKernels(64 * 64, cuda_device)
    raw, ref_raw = _blocks("random", 64, cuda_device)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            k.measure_i8_spec_plain(raw, ref_raw)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
