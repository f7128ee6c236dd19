"""Error metrics and verification gates (port of
`flash_attention_tpu/utils/metrics.py`): the symmetric relative error
`|a-b| / (|a|+|b|+eps)` with a 1% report and 2% pass threshold, max-abs
error, and the low-precision gate (kernel error within 3x a
same-precision baseline's error against an fp32 reference).

Inputs may be torch tensors (any device) or numpy arrays; all math runs
in float32 numpy on the host.
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


def max_abs_error(a, b) -> float:
    """max |a - b| in float32."""
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
    info = _float_info(candidate)
    cand = _np32(candidate)
    ref = _np32(reference)
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


def verify_low_precision(candidate, reference_hi, baseline_lo, *,
                         factor: float = 3.0, atol: float = 1e-6):
    """Gate for bf16/fp16 kernels: the kernel's max-abs error against the
    fp32 reference must not exceed `factor` x the error of a
    same-precision baseline, floored at one ulp of the candidate dtype
    at the reference's magnitude. Returns (passed, kernel_err,
    baseline_err)."""
    info = _float_info(candidate)
    cand = _np32(candidate)
    ref = _np32(reference_hi)
    base = _np32(baseline_lo)
    kernel_err = float(np.max(np.abs(cand - ref)))
    baseline_err = float(np.max(np.abs(base - ref)))
    ulp = (info[0] if info else 0.0) * float(np.max(np.abs(ref)))
    bound = factor * max(baseline_err, ulp) + atol
    return kernel_err <= bound, kernel_err, baseline_err
