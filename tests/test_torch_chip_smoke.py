"""CPU checks of the card script's own logic, which the card runs only as a
whole: `chip_smoke.py`'s report of ptxas' output, its flash phase's limits
(rehearsed on the plain versions, which CPU tensors take, and held against
an emulation of the tensor-core kernels' bf16 and fp16 arithmetic, fp16's
range scaling included, at every head dim the kernels are built for), its
profile's attribution of the grouped-query repeat, the refusal of its
`--compare` mode to run without a card, its generate phase rehearsed at
llama_tiny, the families' and Mixtral's phases and `kernels` rows
rehearsed at their tiny configs, and the fp8 and ResNet phase with the
limit of its fp8 products (held against an emulation of the tensor cores'
shortened accumulation)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from accelerate_tpu_torch.ops import flash_attention as fa
from accelerate_tpu_torch.models import llama_tiny
from accelerate_tpu_torch.parallel.expert import expert_capacity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Lines as nvcc -Xptxas -v prints them for this repo's kernels.
PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__877b7aaa_18_flash_attention_cu_5326155222flash_fwd_wgmma_kernelILi64ELi128ELi2EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__877b7aaa_18_flash_attention_cu_5326155222flash_fwd_wgmma_kernelILi64ELi128ELi2EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16Pfiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the wgmma pipeline in the function
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__877b7aaa_18_flash_attention_cu_5326155220flash_bwd_dkv_kernelI13__nv_bfloat16Li64EEEvPKT_S3_S3_S3_PKfS5_PS1_S6_iifi' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 120 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__877b7aaa_18_flash_attention_cu_5326155216flash_fwd_kernelIfLi32EEEvPKT_S3_S3_PS1_Pfiifi' for 'sm_90a'
ptxas info    : Used 79 registers, used 1 barriers
"""


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_ptxas_report_names_each_kernel():
    lines = chip_smoke.ptxas_report(PTXAS_LOG)
    assert lines == [
        "flash_fwd_wgmma_kernel<64,128,2>: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "flash_fwd_wgmma_kernel<64,128,2>: Used 128 registers, used 1 barriers",
        PTXAS_LOG.splitlines()[4].strip(),
        "flash_bwd_dkv_kernel<bf16,64>: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "flash_bwd_dkv_kernel<bf16,64>: Used 120 registers, used 1 barriers",
        "flash_fwd_kernel<f32,32>: Used 79 registers, used 1 barriers",
    ]


def test_flash_phase_holds_bf16_k3_k5_to_their_rounding_bound():
    """The flash phase on CPU tensors: the plain versions meet every limit;
    bf16 K3's o, K4's dk and dv and K5's dq are held element by element
    within atol 2e-3 + rtol 1e-2 |ref| plus the bound of their bf16
    rounding (fp16's within atol 1e-3 + rtol 5e-3 |ref| plus the bound at
    fp16's unit), and report that
    limit, the limit without the bound and SDPA under both; every other
    limit is a constant; each output carries SDPA's error beside the
    kernel's. fp16 K4 and K5 also carry the range case."""
    results = chip_smoke.flash_kernel_phase(torch.device("cpu"), shape=dict(b=1, hq=2, s=128, d=32), timed=False)
    narrow = {"bfloat16": (dict(atol=chip_smoke.BF16_ATOL, rtol=chip_smoke.BF16_RTOL), "2^-8"),
              "float16": (dict(atol=chip_smoke.FP16_ATOL, rtol=chip_smoke.FP16_RTOL), "2^-11")}
    for name, by_dtype in results.items():
        assert set(by_dtype) == {"float32", "bfloat16", "float16"}
        for dtype, row in by_dtype.items():
            for key, entry in row["errors"].items():
                if key == "lse":
                    assert entry["tolerance"] == chip_smoke.FLASH_LSE_TOL
                    continue
                assert 0 < entry["sdpa_max_abs_err"] < 0.1, (name, dtype, key)
                if dtype in narrow and (name, key) in chip_smoke.FLASH_ROUNDED:
                    tol, unit = narrow[dtype]
                    assert entry["tolerance"] == dict(tol, plus=chip_smoke.FLASH_ROUNDED[(name, key)].replace("2^-8", unit))
                    for report in ("limit", "limit_without_bound", "sdpa_limit", "sdpa_limit_without_bound"):
                        assert set(entry[report]) == {"broken", "share", "worst"}, report
                    assert entry["limit"]["broken"] == 0 and entry["limit"]["share"] == 0.0
                elif dtype in narrow:
                    assert entry["tolerance"] == narrow[dtype][0]
                else:
                    assert entry["tolerance"] in chip_smoke.FLASH_F32_TOL.values()
            assert ("range_case" in row) == (dtype == "float16" and name != "flash_fwd"), (name, dtype)
    assert set(chip_smoke.FLASH_ROUNDED) == {("flash_fwd", "o"), ("flash_bwd_dkv", "dk"),
                                             ("flash_bwd_dkv", "dv"), ("flash_bwd_dq", "dq")}


def _bf16_case(bh, s, d, seed, q_scale=1.0, dtype=torch.bfloat16, scales=None):
    rng = np.random.default_rng(seed)
    scales = scales or dict(q=q_scale)
    to = lambda name: torch.as_tensor(rng.normal(size=(bh, s, d)).astype(np.float32) * scales.get(name, 1.0)).to(dtype)  # noqa: E731
    return to("q"), to("k"), to("v"), to("do")


P_SCALE = 2.0 ** 15  # fp16: the kernels narrow P as P * 2^15
DS_TOP, DS_MIN_EXP = 14, -64  # fp16: a row's largest |dS| narrowed into [2^14, 2^15)


def _narrow_p(p, dtype):
    """p (fp32, at most 1) as the kernels feed it to the tensor cores, back in fp32."""
    if dtype == torch.float16:
        return (p * P_SCALE).half().float() / P_SCALE
    return p.to(dtype).float()


def _exponent(x):
    """floor(log2(x)) of x >= 0 as the kernels read it from the bits: -127 for 0."""
    e = torch.frexp(x)[1] - 1
    return torch.where(x > 0, e, torch.full_like(e, -127))


class _DsRange:
    """fp16 K4/K5's dS narrowing over the tiles of one accumulator, row by
    row (a row being a query row in K5, a key row in K4): each tile's dS is
    scaled by 2^(14 - e), e the exponent of the row's largest |dS| so far,
    rounded to fp16 and scaled back. In exact arithmetic that is the
    kernel's rescale-the-accumulator scheme, whose factors are all powers of
    two. `naive` rounds dS to fp16 as it is."""

    def __init__(self, rows_shape, naive=False):
        self.e = torch.full(rows_shape, DS_MIN_EXP, dtype=torch.int32)
        self.naive = naive

    def narrow(self, ds):
        if self.naive:
            return ds.half().float()
        self.e = torch.maximum(self.e, _exponent(ds.abs().amax(-1)))
        mul = torch.pow(2.0, (DS_TOP - self.e).double()).float()[..., None]
        return (ds * mul).half().float() / mul


def _narrow_ds(ds, dtype, rng):
    return rng.narrow(ds) if dtype == torch.float16 else ds.to(dtype).float()


def _k3_arithmetic(q, k, v, scale, tile, drop_last_tile=False):
    """K3's bf16 (fp16) arithmetic, causal with S = Sk: an online softmax
    over key tiles of `tile`, p rounded to q's type (to nearest; in fp16
    scaled by 2^15 first) before p @ v, l summed from the fp32 p, o rounded
    to q's type; `drop_last_tile` leaves the last key tile out, as a wrong
    kernel would."""
    bh, s, d = q.shape
    rows = torch.arange(s)[:, None]
    m = torch.full((bh, s, 1), fa.NEG_INF)
    l, acc = torch.zeros(bh, s, 1), torch.zeros(bh, s, d)
    starts = list(range(0, s, tile))
    for k0 in starts[:-1] if drop_last_tile else starts:
        x = torch.matmul(q.float(), k[:, k0:k0 + tile].float().transpose(-1, -2)) * scale
        x = x.masked_fill(torch.arange(k0, k0 + x.shape[-1])[None, :] > rows, fa.NEG_INF)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        corr, p = torch.exp(m - m_new), torch.exp(x - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(_narrow_p(p, q.dtype), v[:, k0:k0 + tile].float())
        m = m_new
    return (acc / l).to(q.dtype)


def _k5_arithmetic(q, k, v, do, lse, delta, scale, tile, drop_last_tile=False, naive=False):
    """K5's bf16 (fp16) arithmetic: fp32 p and ds over key tiles of `tile`,
    ds rounded to q's type before ds @ k (in fp16 through `_DsRange`), dq
    summed in fp32 and rounded to q's type; `drop_last_tile` zeroes the
    last key tile's ds."""
    p = torch.exp(fa._scores(q, k, True, scale) - lse[..., None])
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - delta[..., None]) * scale
    if drop_last_tile:
        ds[..., -tile:] = 0
    rows = _DsRange(ds.shape[:-1], naive)
    dq = torch.zeros(q.shape)
    for k0 in range(0, k.shape[1], tile):
        dq += torch.matmul(_narrow_ds(ds[..., k0:k0 + tile], q.dtype, rows), k[:, k0:k0 + tile].float())
    return dq.to(q.dtype)


def _k4_arithmetic(q, k, v, do, lse, delta, scale, tile, drop_last_tile=False, naive=False):
    """K4's bf16 (fp16) arithmetic, causal with S = Sk: per 64-key block,
    query tiles of `tile` rows streamed from the first that sees the block;
    fp32 pT and dsT, pT rounded to q's type before pT @ do (in fp16 scaled by
    2^15 first) and dsT before dsT @ q (in fp16 through `_DsRange`, a row
    being a key), dk and dv summed in fp32 and rounded to q's type;
    `drop_last_tile` leaves the last query tile out, as a wrong kernel
    would."""
    bh, s, d = q.shape
    dk, dv = torch.zeros(bh, s, d), torch.zeros(bh, s, d)
    starts = list(range(0, s, tile))
    for k0 in range(0, s, 64):
        keys = torch.arange(k0, k0 + 64)[:, None]
        rows = _DsRange((bh, 64), naive)
        for i0 in [i0 for i0 in starts if i0 + tile > k0][:-1 if drop_last_tile else None]:
            qt, dot = q[:, i0:i0 + tile].float(), do[:, i0:i0 + tile].float()
            sT = torch.matmul(k[:, k0:k0 + 64].float(), qt.transpose(-1, -2)) * scale
            hidden = keys > torch.arange(i0, i0 + tile)[None, :]
            pT = torch.exp(sT - lse[:, None, i0:i0 + tile]).masked_fill(hidden, 0.0)
            dpT = torch.matmul(v[:, k0:k0 + 64].float(), dot.transpose(-1, -2))
            dsT = pT * (dpT - delta[:, None, i0:i0 + tile]) * scale
            dv[:, k0:k0 + 64] += torch.matmul(_narrow_p(pT, q.dtype), dot)
            dk[:, k0:k0 + 64] += torch.matmul(_narrow_ds(dsT, q.dtype, rows), qt)
    return {"dk": dk.to(q.dtype), "dv": dv.to(q.dtype)}


OUTPUTS = [pytest.param(("flash_fwd", "o"), id="flash_fwd"), pytest.param(("flash_bwd_dq", "dq"), id="flash_bwd_dq"),
           pytest.param(("flash_bwd_dkv", "dk"), id="flash_bwd_dkv-dk"),
           pytest.param(("flash_bwd_dkv", "dv"), id="flash_bwd_dkv-dv")]


def _right_and_wrong(name, key, q, k, v, do, lse, delta, scale, tile):
    """The kernel's arithmetic for output `key` of `name`, and the same with
    its last key tile (K4: query tile) left out."""
    if name == "flash_fwd":
        return (_k3_arithmetic(q, k, v, scale, tile, drop) for drop in (False, True))
    if name == "flash_bwd_dq":
        return (_k5_arithmetic(q, k, v, do, lse, delta, scale, 64, drop) for drop in (False, True))
    return (_k4_arithmetic(q, k, v, do, lse, delta, scale, 64, drop)[key] for drop in (False, True))


@pytest.mark.parametrize("d,tile,q_scale", [(64, 128, 1.0), (128, 64, 1.0), (32, 128, 8.0), (96, 64, 1.0),
                                             (256, 64, 1.0)],
                         ids=["d64", "d128", "d32-scores-x8", "d96", "d256"])
@pytest.mark.parametrize("output", OUTPUTS)
def test_rounding_bound_takes_the_kernels_arithmetic_and_catches_a_lost_tile(output, d, tile, q_scale):
    """The bf16 limit of K3's o, K4's dk and dv and K5's dq (atol + rtol
    |ref| + the rounding bound) holds for the tensor-core kernels'
    arithmetic with room to spare and breaks, by far, where the last key
    tile (K4: query tile) is left out. `tile` is K3's key tile; K4 streams
    64-row query tiles, and K5 64-key tiles, as the kernels."""
    name, key = output
    q, k, v, do = _bf16_case(4, 512, d, seed=d, q_scale=q_scale)
    scale = d ** -0.5
    ref_o, lse = fa.flash_fwd_reference(q, k, v, True, scale)
    delta = fa._delta(ref_o, do)
    if name == "flash_fwd":
        ref = ref_o
        right, wrong = (_k3_arithmetic(q, k, v, scale, tile, drop) for drop in (False, True))
    elif name == "flash_bwd_dq":
        ref = fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, True, scale)
        right, wrong = (_k5_arithmetic(q, k, v, do, lse, delta, scale, tile, drop) for drop in (False, True))
    else:
        ref = dict(zip(("dk", "dv"), fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, True, scale)))[key]
        right, wrong = (_k4_arithmetic(q, k, v, do, lse, delta, scale, 64, drop)[key]
                        for drop in (False, True))
    bound = chip_smoke.flash_rounding_bound(name, key, q, k, v, do, lse, delta, True, scale)
    tol = dict(atol=chip_smoke.BF16_ATOL, rtol=chip_smoke.BF16_RTOL)
    held = chip_smoke.limit_report(right, ref, **tol, bound=bound)
    assert held["broken"] == 0 and held["share"] < 0.75, held
    caught = chip_smoke.limit_report(wrong, ref, **tol, bound=bound)
    assert caught["broken"] > 100 and caught["share"] > 5, caught


def _plain(name, key, q, k, v, do, lse, delta, scale):
    if name == "flash_fwd":
        return fa.flash_fwd_reference(q, k, v, True, scale)[0]
    if name == "flash_bwd_dq":
        return fa.flash_bwd_dq_reference(q, k, v, do, lse, delta, True, scale)
    return dict(zip(("dk", "dv"), fa.flash_bwd_dkv_reference(q, k, v, do, lse, delta, True, scale)))[key]


@pytest.mark.parametrize("d,tile,q_scale", [(64, 128, 1.0), (128, 64, 1.0), (32, 128, 8.0), (96, 64, 1.0),
                                             (256, 64, 1.0)],
                         ids=["d64", "d128", "d32-scores-x8", "d96", "d256"])
@pytest.mark.parametrize("output", OUTPUTS)
def test_fp16_rounding_bound_takes_the_kernels_arithmetic_and_catches_a_lost_tile(output, d, tile, q_scale):
    """The fp16 twin: the limit of fp16 K3's o, K4's dk and dv and K5's dq
    (atol 1e-3 + rtol 5e-3 |ref| + 2^-11 times the rounding term) holds for
    the kernels' fp16 arithmetic, P scaled by 2^15 and dS by a power of two
    per row before each is rounded, and breaks, by far, where the last tile
    is left out."""
    name, key = output
    q, k, v, do = _bf16_case(4, 512, d, seed=d, q_scale=q_scale, dtype=torch.float16)
    scale = d ** -0.5
    ref_o, lse = fa.flash_fwd_reference(q, k, v, True, scale)
    delta = fa._delta(ref_o, do)
    ref = _plain(name, key, q, k, v, do, lse, delta, scale)
    right, wrong = _right_and_wrong(name, key, q, k, v, do, lse, delta, scale, tile)
    assert right.dtype == torch.float16
    bound = chip_smoke.flash_rounding_bound(name, key, q, k, v, do, lse, delta, True, scale)
    tol = chip_smoke.flash_tolerance(torch.float16, key)
    assert tol == dict(atol=1e-3, rtol=5e-3)
    held = chip_smoke.limit_report(right, ref, **tol, bound=bound)
    assert held["broken"] == 0 and held["share"] < 0.75, held
    caught = chip_smoke.limit_report(wrong, ref, **tol, bound=bound)
    assert caught["broken"] > 100 and caught["share"] > 5, caught


@pytest.mark.parametrize("output", [o for o in OUTPUTS if o.values[0][0] != "flash_fwd"])
def test_fp16_range_case_stays_finite_in_the_kernels_arithmetic(output):
    """chip_smoke's range case (dO and V large, as under loss scaling) at 2
    heads: the plain version's |dS| passes fp16's 65504 while dk, dv and dq
    fit. The kernels' arithmetic, with dS scaled per row before it is
    rounded, stays finite and within the fp16 limit; dS rounded as it is
    overflows to inf."""
    name, key = output
    q, k, v, do = _bf16_case(2, 2048, 64, seed=5, dtype=torch.float16, scales=chip_smoke.FLASH_RANGE_SCALES)
    scale = 64 ** -0.5
    ref_o, lse = fa.flash_fwd_reference(q, k, v, True, scale)
    delta = fa._delta(ref_o, do)
    ref = _plain(name, key, q, k, v, do, lse, delta, scale)
    p = torch.exp(fa._scores(q, k, True, scale) - lse[..., None])
    ds = p * (torch.matmul(do.float(), v.float().transpose(-1, -2)) - delta[..., None]) * scale
    assert float(ds.abs().max()) > chip_smoke.FP16_MAX > float(ref.float().abs().max())
    emulate = _k5_arithmetic if name == "flash_bwd_dq" else _k4_arithmetic
    outs = {naive: emulate(q, k, v, do, lse, delta, scale, 64, naive=naive) for naive in (False, True)}
    right, naive = (x if name == "flash_bwd_dq" else x[key] for x in (outs[False], outs[True]))
    assert torch.isfinite(right).all()
    bound = chip_smoke.flash_rounding_bound(name, key, q, k, v, do, lse, delta, True, scale)
    held = chip_smoke.limit_report(right, ref, **chip_smoke.flash_tolerance(torch.float16, key), bound=bound)
    assert held["broken"] == 0, held
    if key != "dv":  # dv takes P and dO, never dS
        assert not torch.isfinite(naive).all()


def test_gqa_repeat_time_finds_each_layers_k_and_v_repeat():
    """The profile's grouped-query repeat, on a `llama_tiny` step on the CPU
    (4 query heads over 2 K/V heads, 2 layers): one forward copy and one
    backward group sum for K and for V in each layer, and no other op
    counted (device times are 0 without a card)."""
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch import Accelerator, BatchSampler, SimpleDataLoader, create_llama_model
    from accelerate_tpu_torch.models import llama_tiny
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    config = llama_tiny()
    rows = np.random.default_rng(0).integers(0, config.vocab_size, (2, 64))
    AcceleratorState._reset_state()
    GradientState._reset_state()
    try:
        model = create_llama_model(config, seed=0, device=torch.device("cpu"))
        accelerator = Accelerator(cpu=True)
        optimizer = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-4)
        data = [{"input_ids": r} for r in rows]
        _, _, loader = accelerator.prepare(model, optimizer, SimpleDataLoader(data, BatchSampler(range(2), 2)))
        step_fn = accelerator.train_step(max_grad_norm=1.0)
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            step_fn(next(iter(loader)))
    finally:
        AcceleratorState._reset_state()
        GradientState._reset_state()
    calls = 2 * config.num_hidden_layers
    assert chip_smoke.gqa_repeat_time(prof) == {"forward_ms": 0.0, "forward_calls": calls,
                                                "backward_ms": 0.0, "backward_calls": calls}


def test_limit_report_names_the_worst_element():
    ref = torch.tensor([[0.0, 1.0], [2.0, -4.0]])
    got = torch.tensor([[0.001, 1.0], [2.0, -3.9]]).bfloat16()
    report = chip_smoke.limit_report(got, ref, atol=2e-3, rtol=1e-2)
    assert report["broken"] == 1 and report["worst"]["index"] == [1, 1]
    assert report["worst"]["ref"] == -4.0 and report["worst"]["limit"] == pytest.approx(0.042)
    assert report["share"] == pytest.approx(report["worst"]["err"] / 0.042)
    assert chip_smoke.limit_report(got, ref, atol=2e-3, rtol=1e-2, bound=torch.full((2, 2), 0.1))["broken"] == 0


def test_compare_flash_kernels_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    run = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--compare", ROOT],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 2 and "needs a CUDA device" in run.stderr
    assert "[compare]" not in run.stdout


def test_compare_paged_kernels_refuses_without_a_card():
    """The per-tree worker, which builds and times K1/K2 before the flash
    kernels, refuses as `--compare` does."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    run = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--compare-worker", ROOT],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 2 and "needs a CUDA device" in run.stderr
    assert "[compare]" not in run.stdout


# Lines as nvcc -Xptxas -v prints them for the paged kernels.
PAGED_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122paged_split_mma_kernelIaLi64ELi2EEEvPK13__nv_bfloat16PKT_S6_PKfS8_PKiSA_Pfiiiiiiiiif' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 216 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122paged_split_mma_kernelI13__nv_fp8_e4m3Li32ELi1EEEvPK13__nv_bfloat16PKT_S6_PKfS8_PKiSA_Pfiiiiiiiiif' for 'sm_90a'
ptxas info    : Used 106 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125paged_split_scalar_kernelIfaEEvPKT_PKT0_S6_PKfS8_PKiSA_Pfiiiiiiiiif' for 'sm_90a'
ptxas info    : Used 48 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125paged_split_scalar_kernelI13__nv_bfloat16S1_EEvPKT_PKT0_S7_PKfS9_PKiSB_Pfiiiiiiiiif' for 'sm_90a'
ptxas info    : Used 50 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118paged_merge_kernelI13__nv_bfloat16EEvPKfPKiPT_iiiiiiiii' for 'sm_90a'
ptxas info    : Used 32 registers, used 0 barriers
"""


def test_ptxas_report_names_the_paged_kernels():
    """The split kernels' template arguments (the tensor-core kernel's pool
    type, head dimension and row tiles; the scalar kernel's query and pool
    types, a repeated type given by substitution) and the merge kernel's
    output type."""
    assert chip_smoke.ptxas_report(PAGED_PTXAS_LOG) == [
        "paged_split_mma_kernel<int8,64,2>: 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "paged_split_mma_kernel<int8,64,2>: Used 216 registers, used 1 barriers",
        "paged_split_mma_kernel<fp8,32,1>: Used 106 registers, used 1 barriers",
        "paged_split_scalar_kernel<f32,int8>: Used 48 registers, used 1 barriers",
        "paged_split_scalar_kernel<bf16,bf16>: Used 50 registers, used 1 barriers",
        "paged_merge_kernel<bf16>: Used 32 registers, used 0 barriers",
    ]


def test_generate_phase_rehearses_on_the_cpu():
    """The generate phase at llama_tiny on the CPU: its f32 identities hold
    (generate against the paged engine, speculative and left-padded against
    plain, the penalty against the penalized engine, the contiguous engine
    against the paged one), its bf16 readings come back, and no K1-K5 count
    moves."""
    small = dict(max_length=768, prompt=24, new=8, batch=3, ragged=(5, 12, 24), penalty=1.3,
                 timed_prompt=32, timed_new=8, timed_batch=3, timed_ragged=(8, 32), passage=8, draft=3)
    report = chip_smoke.generate_phase(torch.device("cpu"), "llama-tiny", shape=small, n_requests=4, system_len=16)
    assert report["f32_contiguous_and_paged_kernel_engine_tokens"] is True
    assert report["bf16_engines"]["contiguous"]["attention_impl"] == "gather"
    assert report["bf16_speculative"]["verify_steps"] > 0
    assert report["bf16_batch_ragged"]["batch"] == 3
    assert not any(report["launches_on_generate_and_contiguous"].values())


def test_remat_phase_rehearses_on_the_cpu():
    """Training (f) at llama_tiny on the CPU: the f32 losses under `full` and
    `dots` equal those without remat, and each bf16 run reports its step
    time and losses (the flash gate stays shut here, so no launch counts)."""
    report = chip_smoke.remat_phase(torch.device("cpu"), "llama-tiny", seq=64, timed_steps=2, warmup=1)
    assert report["f32_parity"]["max_rel_diff"] == {"full": 0.0, "dots": 0.0}
    assert set(report["bf16"]) == {"None", "full", "dots"}
    for run in report["bf16"].values():
        assert run["timed_steps"] == 2 and len(run["losses"]) == 3 and run["step_ms_median"] > 0
    launches = chip_smoke.remat_launches(16 * 4, "full", torch.bfloat16)
    assert (launches["flash_fwd"], launches["flash_bwd_dkv"], launches["flash_bwd_dq"]) == (128, 64, 64)
    assert chip_smoke.remat_launches(16 * 4, None, torch.bfloat16)["flash_fwd"] == 64


def test_bert_phase_rehearses_on_the_cpu():
    """The BERT phase at bert_tiny on the CPU: logits against themselves, the
    twin example's per-epoch losses (finite, falling) and its step timing,
    one step under each remat policy."""
    report = chip_smoke.bert_phase(torch.device("cpu"), "bert-tiny", logits_batch=2, seq=32, example_args=(
        "--train_size", "64", "--eval_size", "32", "--batch_size", "16", "--epochs", "2"))
    example = report["example"]
    assert report["f32_logits_vs_cpu"]["max_abs_err"] == 0.0
    assert example["steps_timed"] == 6 and example["step_ms_median"] > 0
    assert len(example["losses"]) == 2 and example["losses"][-1] < example["losses"][0]
    assert example["args"]["mixed_precision"] == "bf16" and example["args"]["cpu"] is True
    assert set(report["one_step_peak_memory_bytes"]) == {"batch", "seq", "None", "full"}


def _timed(rows):
    """A rehearsal's untimed kernel rows with the card's time keys filled
    (times exist only on the card)."""
    keys = ("ms", "device_ms", "library_ms", "library_device_ms", "plain_ms")
    for row in rows.values():
        for entry in row.values():
            entry.update({k: 0.0 for k in keys if k not in entry})
    return rows


def test_neox_engine_phase_rehearses_on_the_cpu(monkeypatch):
    """GPT-NeoX through the engine phase at a tiny config on the CPU: the f32
    cut's kernel and gather tokens agree (unquantized, int8 and fp8 caches),
    `generate` gives the K1 engine's tokens, the bf16 and int8-weight runs
    come back; then the K1/K2 rows of the `kernels` line at NeoX's kernel
    shape (Hq = Hkv, D 96), cut small, from those runs."""
    import dataclasses

    from accelerate_tpu_torch.models import MODEL_REGISTRY, gpt_neox

    cpu = torch.device("cpu")
    monkeypatch.setitem(MODEL_REGISTRY, "gpt-neox-rehearsal", lambda: dataclasses.replace(
        gpt_neox.gpt_neox_tiny(), num_hidden_layers=4, max_position_embeddings=1024))
    monkeypatch.setattr(chip_smoke, "ENGINE_KW", dict(num_slots=4, page_size=16, max_length=768, chunk_size=8))
    report = chip_smoke.neox_engine_phase(cpu, "gpt-neox-rehearsal", parity_layers=2, w8_layers=2, n_requests=4,
                                          system_len=16, new=6, n_prompts=2)
    assert report["f32_plain_identical"] and report["f32_kv_fp8_e4m3_speculative_identical"]
    assert report["f32_generate_equals_paged_kernel_engine"] == 2
    assert report["bf16_w8_int8_plain"]["kv_cache_nbytes"] < report["bf16_w8_int8_plain"]["bf16_kv_cache_nbytes"]
    shape = dict(chip_smoke.NEOX_KERNEL_SHAPE, slots=4, hq=4, hkv=4, max_length=256)
    kernels = chip_smoke.kernel_phase(cpu, shape, timed=False)
    kernels.update(chip_smoke.quantized_kernel_phase(cpu, shape, timed=False))
    rows = chip_smoke.paged_rows(_timed(kernels), report, shape, chip_smoke.PAGED_SCALAR_DESIGN, suffix="_neox")
    assert [row["name"] for row in rows] == [f"paged_{key}_neox" for key in (
        "decode", "verify", "decode_int8", "decode_fp8_e4m3", "verify_int8", "verify_fp8_e4m3")]
    assert all(row["shape"]["d"] == 96 and row["shape"]["hq"] == row["shape"]["hkv"] for row in rows)


@pytest.mark.parametrize("name", ["gpt-neox-tiny", "gptj-tiny", "opt-tiny"])
def test_family_phases_rehearse_on_the_cpu(name):
    """Each family's generate phase (bf16, batch 1, no K1-K5 launch) and
    training phase (f32 kernel-path losses against the plain ones, bf16
    losses falling, an fp16 step) at its tiny config on the CPU, and the
    `kernels` line's K3-K5 rows at a wide head dim from a flash phase and
    those runs' launch counts."""
    cpu = torch.device("cpu")
    shape = dict(chip_smoke.GENERATE_SHAPE, max_length=256, timed_prompt=32, timed_new=6)
    generated = chip_smoke.family_generate_phase(cpu, name, shape=shape)
    assert generated["bf16_batch1"]["new_tokens"] == 6 and not any(generated["launches"].values())
    trained = chip_smoke.family_training_phase(cpu, name, 2, seq=64, timed_steps=2, warmup=1, fp16_steps=1,
                                               parity_steps=2)
    assert trained["f32_parity"]["max_rel_diff"] == 0.0
    assert trained["bf16"]["losses"][-1] < trained["bf16"]["losses"][0]
    assert len(trained["fp16"]["losses"]) == 1
    d = 96 if name == "gpt-neox-tiny" else 256
    wide = dict(b=1, hq=1, s=128, d=d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "flash_range_case", lambda device, shape: {})  # the range needs S 2048
        phase = chip_smoke.flash_kernel_phase(cpu, shape=wide, timed=False)
    rows = chip_smoke.flash_rows(_timed(phase), trained["bf16"]["launches"], trained["fp16"]["launches"], wide,
                                 suffix=f"_d{d}", design=chip_smoke.WIDE_FLASH_DESIGN[d])
    assert [row["name"] for row in rows] == [f"{k}_d{d}" for k in (
        "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd_f16", "flash_bwd_dkv_f16", "flash_bwd_dq_f16")]
    assert all(row["shape"]["d"] == d and "launches" in row and "bound_ms" in row for row in rows)


def test_flash_bound_counts_the_pairs_each_mask_leaves():
    """Non-causal: every query sees every key, S x Sk pairs (T5's cross
    shape: 1024 x 2048); causal over Sq < Skv: query i sees i + Sk - S + 1
    keys. Operations: 2, 4 and 3 products of 2 BH pairs D; bytes each input
    read once, each output written once."""
    shape = chip_smoke.T5_CROSS_FLASH_SHAPE
    bh, s, sk, d = shape["b"] * shape["hq"], shape["s"], shape["sk"], shape["d"]
    q = torch.empty((bh, s, d), dtype=torch.bfloat16, device="meta")
    k = torch.empty((bh, sk, d), dtype=torch.bfloat16, device="meta")
    for name, products in (("flash_fwd", 2), ("flash_bwd_dkv", 4), ("flash_bwd_dq", 3)):
        ms, by = chip_smoke.flash_bound(name, q, k, causal=False)
        assert by == "operations"
        assert ms == pytest.approx(1e3 * products * 2 * bh * s * sk * d / 989e12, rel=1e-12)
        causal_ms, _ = chip_smoke.flash_bound(name, q, k, causal=True)
        pairs = sum(i + sk - s + 1 for i in range(s))
        assert causal_ms == pytest.approx(ms * pairs / (s * sk), rel=1e-12)
    q32 = torch.empty((4, 128, 64), dtype=torch.float32, device="meta")
    ms, by = chip_smoke.flash_bound("flash_fwd", q32, q32, causal=False)
    assert ms == pytest.approx(1e3 * 2 * 2 * 4 * 128 * 128 * 64 / 67e12, rel=1e-12) and by == "operations"


def test_t5_phases_rehearse_on_the_cpu(monkeypatch):
    """The T5 phases at t5_tiny on the CPU: the non-causal flash phase at
    scale 1.0 (f32 and bf16, no fp16 range case) and its `*_t5cross` rows
    from the training run's launches; training (f32 kernel-path losses equal
    the plain ones here, where the gate stays shut; bf16 losses falling);
    `Seq2SeqGenerator` against the uncached loop and its bf16 readings; the
    HF round trips of a Llama engine and a T5."""
    cpu = torch.device("cpu")
    shape = dict(b=1, hq=2, s=64, sk=128, d=32)
    phase = chip_smoke.flash_kernel_phase(cpu, shape, timed=False, causal=False, scale=1.0,
                                          dtypes=(torch.float32, torch.bfloat16))
    assert set(phase["flash_fwd"]) == {"float32", "bfloat16"}
    assert all(row["bfloat16"]["errors"]["o" if name == "flash_fwd" else next(iter(row["bfloat16"]["errors"]))]
               ["limit"]["broken"] == 0 for name, row in phase.items())
    trained = chip_smoke.t5_training_phase(cpu, "t5-tiny", layers=2, enc_seq=64, dec_seq=32, timed_steps=2, warmup=1)
    parity = trained["f32_parity"]
    assert parity["rel_diff"]["flash_vs_xla"] == [0.0] * 3 and len(parity["losses"]["f64"]) == 3
    assert parity["grad_rel_norm_diff"]["flash_vs_xla"]["rel_norm_diff"] == 0.0
    assert 0 < parity["grad_rel_norm_diff"]["xla_vs_f64"]["rel_norm_diff"] < 1e-4
    assert trained["bf16"]["losses"][-1] < trained["bf16"]["losses"][0] and trained["bf16"]["mfu"] > 0
    want = chip_smoke.expected_launches(2 * 4, torch.bfloat16)
    assert (want["flash_fwd"], want["flash_bwd_dkv"], want["flash_bwd_dq"], want["flash_fwd_f16"]) == (8, 8, 8, 0)
    rows = chip_smoke.flash_rows(_timed(phase), want, None, shape, suffix="_t5cross",
                                 design=chip_smoke.T5_CROSS_DESIGN, causal=False, scale=1.0)
    assert [row["name"] for row in rows] == ["flash_fwd_t5cross", "flash_bwd_dkv_t5cross", "flash_bwd_dq_t5cross"]
    for row in rows:
        assert row["shape"]["causal"] is False and row["shape"]["scale"] == 1.0 and row["launches"] == 8
        assert "is_causal=False, scale=1.0" in row["library_call"] and row["bound_by"] in ("bytes", "operations")
    generated = chip_smoke.t5_generate_phase(cpu, "t5-tiny", shape=dict(
        batch=3, prompt=24, new=6, padded=((1, 10),), parity_layers=2, parity_batch=2, parity_prompt=12,
        parity_new=5))
    assert generated["f32_parity"]["tokens_equal_uncached_loop"]
    assert generated["bf16"]["new_tokens"] == 6 and generated["bf16"]["step_bound_ms"] > 0
    assert not any(generated["launches"].values())
    monkeypatch.setattr(chip_smoke, "ENGINE_KW", dict(num_slots=4, page_size=16, max_length=768, chunk_size=8))
    hf = chip_smoke.hf_phase(cpu, "llama-tiny", t5_name="t5-tiny", n_requests=4, system_len=16,
                             mixtral_name="mixtral-tiny")
    assert hf["plain_tokens_equal"] == hf["speculative_tokens_equal"] == 4
    assert hf["llama"]["file_bytes"] > 0 and hf["t5"]["logits_bit_equal"]
    assert hf["mixtral"]["greedy_tokens_equal"] and hf["mixtral"]["file_bytes"] > 0


def test_head_dim_16_is_a_compare_choice():
    """`--head-dim 16` is accepted (the refusal is the card's, not
    argparse's), and 128 stays one."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    for d in ("16", "128"):
        run = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--compare", ROOT, "--head-dim", d],
                             capture_output=True, text=True, timeout=120)
        assert run.returncode == 2 and "needs a CUDA device" in run.stderr and "invalid choice" not in run.stderr


def test_mixtral_phases_rehearse_on_the_cpu(monkeypatch):
    """The Mixtral slice's phases at `mixtral-tiny` on the CPU: (a) the head
    dim 16 kernels against their plain versions and T5-tiny's forward and
    backward (the gate stays shut here: no launch, equal losses); (c)
    generation, f32 dropless cached against full context, bf16 timings and
    the router's drops at the prefill and each decode step; (d) training,
    f32 parity, bf16 losses falling with finite ce and router losses, the
    MoE FLOP count; and the `kernels` line's `_d16` (non-causal, scale 1.0)
    and `_d128` rows from those runs' launches."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(chip_smoke, "flash_range_case", lambda device, shape: {})  # the range needs S 2048
    d16_shape = dict(b=1, hq=2, s=128, d=16)
    d16 = chip_smoke.head_dim_16_phase(cpu, shape=d16_shape, seq=128, timed=False)
    assert d16["t5"]["head_dim"] == 16 and d16["t5"]["f32_abs_diff"] == 0.0
    for phase in (d16["causal"], d16["non_causal"]):
        assert set(phase["flash_fwd"]) == {"float32", "bfloat16", "float16"}
        for name, row in phase.items():
            assert all(entry["limit"]["broken"] == 0 for dtype in ("bfloat16", "float16")
                       for key, entry in row[dtype]["errors"].items() if key != "lse"), name
    generated = chip_smoke.mixtral_generate_phase(cpu, "mixtral-tiny", shape=dict(
        layers=2, max_length=128, prompt=32, new=6, batch=3, ragged=(8, 32), parity_layers=2, parity_batch=2,
        parity_prompt=12, parity_new=5, profile_new=4))
    assert generated["f32_dropless"]["cached_equals_full_context"] and not any(generated["launches"].values())
    drops = generated["router_drops"]
    assert drops["prefill"]["tokens"] == 3 * 32 and drops["decode_steps"] == 5 and drops["decode_tokens_per_step"] == 3
    assert drops["prefill"]["capacity"] == expert_capacity(3 * 32, 4, 2, 1.25) == 60
    trained = chip_smoke.mixtral_training_phase(cpu, "mixtral-tiny", layers=2, narrow={}, shape=dict(
        batch=1, seq=64, warmup=1, timed_steps=2, fp16_steps=1, parity_steps=2))
    assert trained["f32_parity"]["max_rel_diff"] == 0.0
    bf16 = trained["bf16"]
    assert bf16["losses"][-1] < bf16["losses"][0] and bf16["mfu"] > 0
    assert [sorted(a) for a in bf16["aux"]] == [["ce", "load_balance_loss", "router_z_loss"]] * 3
    cfg = chip_smoke.mixtral_config("mixtral-8x7b", num_hidden_layers=2)
    flops = chip_smoke.mixtral_step_flops(cfg, 1, 2048)
    c = 640  # ceil(2048 * 2 / 8 * 1.25)
    experts = 3 * 2 * 6 * 8 * c * 4096 * 14336
    assert experts < flops < 1.4 * experts
    want = chip_smoke.expected_launches(2, torch.bfloat16)
    want16 = chip_smoke.expected_launches(2, torch.float16)
    rows = chip_smoke.flash_rows(_timed(d16["non_causal"]), want, want16, d16_shape, suffix="_d16",
                                 design=chip_smoke.WIDE_FLASH_DESIGN[16], causal=False, scale=1.0)
    assert [row["name"] for row in rows] == [f"{k}_d16" for k in (
        "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd_f16", "flash_bwd_dkv_f16", "flash_bwd_dq_f16")]
    assert all(row["shape"]["scale"] == 1.0 and row["shape"]["causal"] is False and row["launches"] == 2
               and "is_causal=False, scale=1.0" in row["library_call"] for row in rows)
    d128 = dict(chip_smoke.FAMILY_FLASH_SHAPES[128], s=128)
    phase = chip_smoke.flash_kernel_phase(cpu, shape=d128, timed=False, dtypes=(torch.float32, torch.bfloat16,
                                                                                 torch.float16))
    rows = chip_smoke.flash_rows(_timed(phase), want, want16, d128, suffix="_d128",
                                 design=chip_smoke.WIDE_FLASH_DESIGN[128])
    assert [row["name"] for row in rows][:3] == ["flash_fwd_d128", "flash_bwd_dkv_d128", "flash_bwd_dq_d128"]
    assert all(row["shape"]["d"] == 128 and row["shape"]["hq"] == 32 for row in rows)


def _truncated(v, bits):
    """`v` with its significand cut to `bits` bits, toward zero."""
    mantissa, exponent = torch.frexp(v)
    return torch.ldexp(torch.trunc(mantissa * 2.0 ** bits) / 2.0 ** bits, exponent)


def _fp8_operands(m, k, n, seed=0):
    from accelerate_tpu_torch.ops import fp8 as pfp8

    gen = torch.Generator().manual_seed(seed)
    a, sa = pfp8.quantize_fp8(torch.randn(m, k, generator=gen).bfloat16())
    b, sb = pfp8.quantize_fp8(torch.randn(k, n, generator=gen).bfloat16() * 1e-3, pfp8.E5M2)
    return a, sa, b, sb


@pytest.mark.parametrize("k", [512, 2048, 8192])
def test_fp8_limit_takes_the_tensor_cores_accumulation_and_catches_a_lost_tile(k):
    """Phase 11 (a)'s limit on an fp8 product: a sum that keeps 13 bits of
    each partial sum of 32 products (Hopper's fp8 MMA keeps about 14 inside
    the core) before adding it in f32 stays within it; the same with one
    32-wide slice of K left out breaks it."""
    a, sa, b, sb = _fp8_operands(64, k, 48)
    ref = chip_smoke.fp8_plain(a, sa, b, sb)
    acc = (a.float().abs() @ b.float().abs()) * (sa * sb)
    parts = [_truncated(a[:, i:i + 32].float() @ b[i:i + 32].float(), 13) for i in range(0, k, 32)]
    emulated = (torch.stack(parts).sum(0) * (sa * sb)).bfloat16()
    report = chip_smoke.limit_report(emulated, ref, 0.0, chip_smoke.FP8_RTOL, chip_smoke.FP8_ACC * acc)
    assert report["broken"] == 0 and report["share"] < 1, report
    lost = (torch.stack(parts[1:]).sum(0) * (sa * sb)).bfloat16()
    assert chip_smoke.limit_report(lost, ref, 0.0, chip_smoke.FP8_RTOL, chip_smoke.FP8_ACC * acc)["broken"] > 0


def test_fp8_phases_rehearse_on_the_cpu():
    """Phase 11 at tiny sizes on the CPU: (a) llama_tiny's linear shapes
    through the port's autograd path, each product equal to its plain
    version (the CPU runs it); (b) llama_tiny in fp8 beside bf16 on the same
    batch, every linear layer's product in fp8; (c) fp8 losses under "full"
    remat equal those without, the forward products run twice; (d)
    resnet_tiny learns in bf16 and leaves its BatchNorm buffers as they
    were (the flash gate stays shut here: no launch is counted)."""
    from accelerate_tpu_torch.models import MODEL_REGISTRY
    from accelerate_tpu_torch.models.resnet import resnet_tiny

    cpu = torch.device("cpu")
    products = chip_smoke.fp8_products_phase(cpu, "llama-tiny", tokens=64, timed=False)
    assert sorted(products) == sorted(["wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"])
    for case in products.values():
        assert all(case[role]["max_abs_err"] == 0.0 and case[role]["bound_ms"] > 0 for role in ("fwd", "dx", "dw"))
    assert products["lm_head"]["dw"]["dtypes"] == ["torch.float8_e5m2", "torch.float8_e4m3fn"]
    trained = chip_smoke.fp8_training_phase(cpu, "llama-tiny", seq=64, timed_steps=2, warmup=1)
    n = 7 * 2 + 1
    assert trained["fp8_products"] == {"fwd": 2 * n, "dx": 2 * n, "dw": 2 * n}
    assert trained["losses"][-1] < trained["losses"][0] and len(trained["bf16"]["losses"]) == 3
    assert trained["mfu_over_fp8_peak"] == pytest.approx(trained["mfu"] / 2.001, rel=1e-3)
    remat = chip_smoke.fp8_remat_phase(cpu, "llama-tiny", layers=2, seq=64, steps=2)
    assert remat["max_rel_diff"] == 0.0 and remat["runs"]["full"]["fp8_products"]["fwd"] == 2 * (2 * 14 + 1)
    resnet = chip_smoke.resnet_phase(cpu, resnet_tiny(), shape=dict(batch=8, size=32, warmup=1, timed_steps=3,
                                                                    lr=1e-3, weight_decay=1e-4))
    assert resnet["batchnorm_buffers"] == 27 and resnet["losses"][-1] < resnet["losses"][0]
    shapes = chip_smoke.llama_linear_shapes(MODEL_REGISTRY["llama-1b"]())
    assert (shapes["wk"], shapes["w_down"], shapes["lm_head"]) == ((2048, 512), (8192, 2048), (2048, 128256))


# ---------------------------------------------------------------- phase 13
def test_abba_pairs_two_modes_in_turns():
    order = []
    runs = chip_smoke.abba(lambda label: order.append(label) or len(order), "plain", "instrumented")
    assert order == ["plain", "instrumented", "instrumented", "plain"]
    assert runs == {"plain": [1, 4], "instrumented": [2, 3]}
    order.clear()
    chip_smoke.abba(order.append, "a", "b", rounds=2)
    assert order == ["a", "b", "b", "a"] * 2


def _hand_made(n_requests=3, chunks=2, drop=None):
    """A registry and span records as an engine of `n_requests` requests and
    `chunks` chunks leaves them, with `drop` (a span name) missing once."""
    from accelerate_tpu_torch.telemetry import FlightRecorder, MetricsRegistry, Tracer

    registry, recorder = MetricsRegistry(), FlightRecorder()
    tracer = Tracer(recorder=recorder)
    for rid in range(n_requests):
        registry.counter("serving_requests_submitted_total").inc()
        registry.counter("serving_requests_finished_total", labels={"reason": "length"}).inc()
        registry.histogram("serving_ttft_seconds").observe(0.01)
        request = tracer.start_span("serve.request", request_id=rid)
        tracer.start_span("serve.insert", parent=request).end()
        request.end()
    for _ in range(chunks):
        registry.counter("serving_chunks_total").inc()
        tracer.start_span("serve.decode_chunk", slots="0").end()
    records = [r for r in recorder.records() if r["name"] != drop] + [
        r for r in recorder.records() if r["name"] == drop][1:]
    return registry, records


def test_engine_telemetry_gates_hold_a_hand_made_recorder_and_catch_each_miss():
    registry, records = _hand_made()
    counts = chip_smoke.engine_telemetry_gates(registry, records, {"chunks": 2}, 3)
    assert counts["spans"] == {"serve.request": 3, "serve.insert": 3, "serve.decode_chunk": 2}
    for drop in ("serve.request", "serve.insert", "serve.decode_chunk"):
        registry, records = _hand_made(drop=drop)
        with pytest.raises(RuntimeError, match=drop):
            chip_smoke.engine_telemetry_gates(registry, records, {"chunks": 2}, 3)
    registry, records = _hand_made()
    with pytest.raises(RuntimeError, match="chunks_total"):
        chip_smoke.engine_telemetry_gates(registry, records, {"chunks": 3}, 3)
    with pytest.raises(RuntimeError, match="submitted"):
        chip_smoke.engine_telemetry_gates(registry, records, {"chunks": 2}, 4)
    # the span stream's start records are not completed spans
    start = dict(records[0], kind="span_start")
    assert chip_smoke.span_counts([start] + records) == counts["spans"]


def test_scrape_gate_compares_every_series_and_catches_a_changed_one():
    from accelerate_tpu_torch.telemetry import to_prometheus_text

    registry, _ = _hand_made()
    text = to_prometheus_text(registry)
    assert chip_smoke.scrape_matches(registry, text) == len(registry.instruments())
    with pytest.raises(RuntimeError, match="serving_chunks_total"):
        chip_smoke.scrape_matches(registry, text.replace("serving_chunks_total 2", "serving_chunks_total 3"))
    with pytest.raises(RuntimeError, match="serving_ttft_seconds_count"):
        chip_smoke.scrape_matches(registry, text.replace("serving_ttft_seconds_count 3", ""))


def test_telemetry_phase_rehearses_on_the_cpu():
    """Phase 13 at llama_tiny on the CPU: the instrumented engine's tokens
    equal the plain one's with every count gate holding, plain and
    speculative; the analyzed training's losses equal the plain ones bit for
    bit with 4 steps counted; the planted sync waits for a card."""
    report = chip_smoke.telemetry_phase(torch.device("cpu"), "llama-tiny", n_requests=4, system_len=16, seq=64,
                                        warmup=2, timed_steps=2)
    for label in ("plain", "speculative"):
        runs = report["engine_runs"][label]
        assert all(t["guard"] == {"builds": 0, "syncs": 0} for t in runs["instrumented"])
        assert all(t["counts"]["spans"]["serve.request"] == 4 for t in runs["instrumented"])
    assert len(report["engine_runs"]["plain"]["decode_tokens_per_s"]["plain"]) == 4  # a b b a, twice
    assert report["engine_runs"]["unsanctioned_control"]["sites"] == {}  # the CPU makes no sync
    training = report["training"]
    assert training["losses_bit_for_bit"] is True
    assert all(r["counts"]["train_steps_total"] == 4 for r in training["plain"] + training["analyze"])
    assert training["analyze"][0]["guard"]["steady_steps"] == 2 and training["analyze"][0]["block_samples"] == 2
    assert "profile" in training["analyze"][0]
    assert report["planted_sync"] == {"skipped": "no CUDA device: nothing syncs"}


def test_telemetry_only_refuses_without_a_card_and_is_a_known_flag():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    run = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--telemetry-only"],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 2 and "needs a CUDA device" in run.stderr
    assert "[telemetry]" not in run.stdout and '"ok"' not in run.stdout
    usage = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--help"],
                           capture_output=True, text=True, timeout=120)
    assert usage.returncode == 0 and "--telemetry-only" in usage.stdout


def test_dist_phase_rehearses_on_the_cpu_and_restores_the_environment(monkeypatch):
    """Phase 14 at llama_tiny on the CPU, its world-1 group over gloo: every
    strategy's losses equal the bare run's (here bit for bit), each run in
    the a-b-b-a order; the guard runs count their steady steps; the
    checkpoint resumes with equal losses and loads into the bare
    `Accelerator` unchanged; afterwards no process group is left and the
    launcher's variables are what they were."""
    monkeypatch.setenv("MASTER_PORT", "12345")
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    report = chip_smoke.dist_phase(torch.device("cpu"), "llama-tiny", seq=64, warmup=1, timed_steps=2,
                                   guard_steps=1)
    training = report["training"]
    assert training["order"] == ("bare", "NO_SHARD", "SHARD_GRAD_OP", "FULL_SHARD", "FULL_SHARD", "SHARD_GRAD_OP",
                                 "NO_SHARD", "bare")
    for strategy in ("NO_SHARD", "SHARD_GRAD_OP", "FULL_SHARD"):
        row = training["strategies"][strategy]
        assert row["backend"] == "gloo" and row["losses_bit_for_bit"] is True and len(row["step_ms_median"]) == 2
    assert training["strategies"]["bare"]["backend"] is None
    assert all(report["guard"][s]["steady_steps"] == 1 for s in ("NO_SHARD", "FULL_SHARD"))
    assert report["checkpoint"]["max_rel_diff"] == 0.0 and report["checkpoint"]["bare_weights_mismatched"] == []
    assert not torch.distributed.is_initialized()
    assert os.environ["MASTER_PORT"] == "12345" and "RANK" not in os.environ and "WORLD_SIZE" not in os.environ


def test_dist_gates_catch_parted_losses_and_missing_launches(monkeypatch):
    """Phase 14 (a)'s gates: a NO_SHARD run whose losses part from the bare
    run's by more than 1e-6, or a sharded run's by more than 1e-2, fails;
    so do losses that do not fall."""
    base = [7.0, 6.0, 5.0]

    def fake_run(losses_by_strategy):
        def run(device, config, strategy, *args, **kwargs):
            return {"losses": losses_by_strategy.get(strategy, base), "step_ms_median": 1.0, "tokens_per_s": 1.0,
                    "mfu": 0.1, "launches": {}, "backend": None if strategy == "bare" else "gloo"}
        return run

    config = llama_tiny()
    cpu = torch.device("cpu")
    monkeypatch.setattr(chip_smoke, "dist_run", fake_run({}))
    assert chip_smoke.dist_training(cpu, config, 2, 64, 1, 2)["strategies"]["NO_SHARD"]["losses_bit_for_bit"]
    for strategy, losses in (("NO_SHARD", [7.0, 6.0, 5.0 * (1 + 2e-6)]), ("FULL_SHARD", [7.0, 6.0, 5.1]),
                             ("SHARD_GRAD_OP", [5.0, 6.0, 7.0])):
        monkeypatch.setattr(chip_smoke, "dist_run", fake_run({strategy: losses}))
        with pytest.raises(RuntimeError, match=strategy):
            chip_smoke.dist_training(cpu, config, 2, 64, 1, 2)


def test_dist_only_refuses_without_a_card_and_is_a_known_flag():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    run = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--dist-only"],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 2 and "needs a CUDA device" in run.stderr
    assert "[dist]" not in run.stdout and '"ok"' not in run.stdout
    usage = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--help"],
                           capture_output=True, text=True, timeout=120)
    assert usage.returncode == 0 and "--dist-only" in usage.stdout


SURFACE_CPU = dict(chip_smoke.SURFACE, oom_start=8, shard_size="300KB")
SURFACE_TWINS = dict(cv_args=["--mixed_precision", "no"],
                     early_args=["--mixed_precision", "no", "--train_size", "64", "--eval_size", "32", "--epochs", "6"],
                     tracking_args=["--train_size", "64"])


def test_surface_phase_rehearses_on_the_cpu():
    """Phase 15 at llama_tiny on the CPU (about 6 s): the dispatcher's
    losses equal the shard loader's bit for bit, the lr follows JAX's count,
    `save_model` writes several shards that read back bit for bit, the
    autocast-off logits equal the "no" model's, the batch-size search halves
    from 8 past two stand-in out-of-memory errors and trains at 2, and the
    twins pass (cv_example above 0.5, early stopping stops and clears its
    trigger, the tracker's records are the logged epochs)."""
    report = chip_smoke.surface_phase(torch.device("cpu"), "llama-tiny", seq=64, shape=SURFACE_CPU, cpu_oom_above=2,
                                      **SURFACE_TWINS)
    training = report["training"]
    assert training["dispatcher"]["loader"] == "DataLoaderDispatcher"
    assert training["shard_loader"]["loader"] == "DataLoaderShard"
    assert training["losses_bit_for_bit"] and training["lr_at_jax_count"]
    assert [s["step_count"] for s in training["dispatcher"]["steps"]] == [1, 2, 3, 4]
    assert len(training["dispatcher"]["losses"]) == 8
    assert training["save_model"]["shards"] > 1 and training["save_model"]["round_trip_bit_for_bit"]
    assert training["autocast_off"]["bit_for_bit_with_no"] and training["autocast_off"]["restored"]
    oom = report["oom"]
    assert [a["batch_size"] for a in oom["attempts"]] == [8, 4, 2] and oom["found"] == 2
    assert [c["oom"] for c in oom["caught"]] == [True, True]
    twins = report["twins"]
    assert twins["cv_example"]["accuracy"] > 0.5 and twins["early_stopping"]["stopped_at"] is not None
    assert twins["tracking"]["records"] == 2


def test_surface_gates_catch_parted_losses_a_wrong_lr_and_a_missed_oom(monkeypatch):
    """Phase 15's gates: a shard-loader run whose losses differ from the
    dispatcher's in the last bit, a scheduler off JAX's count, and an error
    the batch-size search does not take as out of memory each fail the
    phase."""
    cpu, config = torch.device("cpu"), llama_tiny()
    real_run = chip_smoke.surface_run

    def parted(device, config, dispatch, *args):
        acc, pmodel, first, report = real_run(device, config, dispatch, *args)
        if not dispatch:
            report["losses"][-1] = np.nextafter(report["losses"][-1], np.inf)
        return acc, pmodel, first, report

    args = (cpu, config, 64, 2, 2, 2, 1.0, "300KB")
    monkeypatch.setattr(chip_smoke, "surface_run", parted)
    with pytest.raises(RuntimeError, match="not the shard loader's"):
        chip_smoke.surface_training(*args)
    monkeypatch.setattr(chip_smoke, "surface_run", real_run)
    from accelerate_tpu_torch import scheduler

    # A scheduler counting as if it stepped for two processes.
    monkeypatch.setattr(scheduler, "PartialState", lambda: type("Two", (), {"num_processes": 2})())
    with pytest.raises(RuntimeError, match="JAX's rule"):
        chip_smoke.surface_training(*args)
    from accelerate_tpu_torch.utils import memory

    monkeypatch.setattr(memory, "is_oom_exception", lambda e: False)
    with pytest.raises(torch.cuda.OutOfMemoryError, match="out of memory"):
        chip_smoke.surface_oom(cpu, config, 64, 8, 64 << 20, cpu_oom_above=2)


def test_surface_only_refuses_without_a_card_and_is_a_known_flag():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    run = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--surface-only"],
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 2 and "needs a CUDA device" in run.stderr
    assert "[surface]" not in run.stdout and '"ok"' not in run.stdout
    usage = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--help"],
                           capture_output=True, text=True, timeout=120)
    assert usage.returncode == 0 and "--surface-only" in usage.stdout
