"""Error metrics and verification gates (port of
`flash_attention_tpu/utils/metrics.py`): the symmetric relative error
`|a-b| / (|a|+|b|+eps)` with a 1% report and 2% pass threshold, max-abs
error, and the low-precision gate (kernel error within 3x a
same-precision baseline's error against an fp32 reference).

Inputs may be torch tensors (any device) or numpy arrays; the math runs
in float32, in numpy on the host, except the max-abs errors of two
tensors on one device (`max_abs_error`, `verify_low_precision`), which
are taken there: the same float32 subtractions and a max, so the same
number, without copying large outputs to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

REPORT_THRESHOLD = 0.01
PASS_THRESHOLD = 0.02
EPS = 1e-6


def _np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


def _float_info(x) -> tuple[float, int] | None:
    """(machine epsilon, bytes per element) of a floating input's dtype,
    None for other dtypes."""
    if isinstance(x, torch.Tensor):
        if not x.dtype.is_floating_point:
            return None
        return torch.finfo(x.dtype).eps, x.element_size()
    dt = np.asarray(x).dtype
    if not np.issubdtype(dt, np.floating):
        return None
    return float(np.finfo(dt).eps), dt.itemsize


def symmetric_relative_error(a, b, eps: float = EPS) -> np.ndarray:
    """Elementwise |a-b| / (|a| + |b| + eps), computed in float32."""
    a, b = _np32(a), _np32(b)
    return np.abs(a - b) / (np.abs(a) + np.abs(b) + eps)


def _abs_max(x) -> float:
    """max |x| in float32, on x's device for a tensor."""
    if isinstance(x, torch.Tensor):
        return float(x.detach().to(torch.float32).abs().max())
    return float(np.max(np.abs(_np32(x))))


def max_abs_error(a, b) -> float:
    """max |a - b| in float32."""
    if (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
            and a.device == b.device):
        return _abs_max(a.detach().to(torch.float32)
                        - b.detach().to(torch.float32))
    return float(np.max(np.abs(_np32(a) - _np32(b))))


@dataclasses.dataclass
class VerifyReport:
    passed: bool
    max_rel_err: float
    mean_rel_err: float
    max_abs_err: float
    num_offenders: int
    total_elements: int
    offenders: list
    pass_threshold: float

    def __str__(self) -> str:
        verdict = "PASS" if self.passed else "FAIL"
        lines = [
            f"[{verdict}] max_rel_err={self.max_rel_err:.6f} "
            f"(threshold {self.pass_threshold}) "
            f"mean_rel_err={self.mean_rel_err:.6f} "
            f"max_abs_err={self.max_abs_err:.6f} "
            f"offenders>{REPORT_THRESHOLD:.0%}: "
            f"{self.num_offenders}/{self.total_elements}"
        ]
        for idx, cand, ref, err in self.offenders:
            lines.append(
                f"  at {idx}: candidate={cand:.6f} reference={ref:.6f} "
                f"rel_err={err:.6f}")
        return "\n".join(lines)


def verify(candidate, reference, *, pass_threshold: float = PASS_THRESHOLD,
           report_threshold: float = REPORT_THRESHOLD,
           max_reported: int = 10) -> VerifyReport:
    """Symmetric relative error gate. For candidates narrower than 32
    bits an element only fails when its absolute error also exceeds 3
    ulps of the dtype at the reference's magnitude (rounding noise on
    near-zero elements is not signal)."""
    return _verify_np(_np32(candidate), _float_info(candidate),
                      _np32(reference), pass_threshold, report_threshold,
                      max_reported)


def _verify_np(cand, info, ref, pass_threshold, report_threshold,
               max_reported) -> VerifyReport:
    """verify on float32 arrays; `info` is _float_info of the candidate
    as given."""
    if cand.shape != ref.shape:
        raise ValueError(f"shape mismatch: {cand.shape} vs {ref.shape}")
    atol = 0.0
    if info is not None and info[1] < 4 and ref.size:
        atol = 3.0 * info[0] * float(np.max(np.abs(ref)))

    abs_diff = np.abs(cand - ref).ravel()
    err = symmetric_relative_error(cand, ref)
    flat_err = err.ravel()
    significant = abs_diff > atol
    offender_mask = (flat_err > report_threshold) & significant
    offender_idx = np.nonzero(offender_mask)[0]
    offenders = []
    for i in offender_idx[:max_reported]:
        multi = np.unravel_index(i, err.shape)
        offenders.append(
            (tuple(int(x) for x in multi), float(cand.ravel()[i]),
             float(ref.ravel()[i]), float(flat_err[i])))
    gated_err = float(np.max(flat_err * significant)) if flat_err.size \
        else 0.0
    return VerifyReport(
        passed=gated_err < pass_threshold,
        max_rel_err=gated_err,
        mean_rel_err=float(flat_err.mean()) if flat_err.size else 0.0,
        max_abs_err=float(abs_diff.max()) if flat_err.size else 0.0,
        num_offenders=int(offender_mask.sum()),
        total_elements=int(flat_err.size),
        offenders=offenders,
        pass_threshold=pass_threshold,
    )


def cross_check(impls: dict, *, pass_threshold: float = PASS_THRESHOLD):
    """All-pairs comparison of named outputs (the reference's N-way
    integration test): {(name_a, name_b): VerifyReport} for every
    unordered pair, name_a the candidate. Each output is copied to the
    host once."""
    arrays = {name: (_np32(x), _float_info(x)) for name, x in impls.items()}
    names = list(arrays)
    reports = {}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            reports[(a, b)] = _verify_np(
                arrays[a][0], arrays[a][1], arrays[b][0], pass_threshold,
                REPORT_THRESHOLD, 10)
    return reports


def verify_low_precision(candidate, reference_hi, baseline_lo, *,
                         factor: float = 3.0, atol: float = 1e-6):
    """Gate for bf16/fp16 kernels: the kernel's max-abs error against the
    fp32 reference must not exceed `factor` x the error of a
    same-precision baseline, floored at one ulp of the candidate dtype
    at the reference's magnitude. Returns (passed, kernel_err,
    baseline_err)."""
    info = _float_info(candidate)
    kernel_err = max_abs_error(candidate, reference_hi)
    baseline_err = max_abs_error(baseline_lo, reference_hi)
    ulp = (info[0] if info else 0.0) * _abs_max(reference_hi)
    bound = factor * max(baseline_err, ulp) + atol
    return kernel_err <= bound, kernel_err, baseline_err
