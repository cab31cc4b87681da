"""Acceleration analytics (paper §5.1): Amdahl limits per stage and the
emulated-acceleration transform applied to measured stage profiles.

The port's own copy of ``repro.core.acceleration`` (which imports
nothing; the port imports nothing of ``repro``):
``tests/test_torch_core_tax.py`` holds the two equal."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StageProfile:
    """CPU-time split of one pipeline stage (paper Fig 8)."""
    name: str
    ai_fraction: float          # fraction of cycles in AI kernels

    def amdahl_speedup(self, s: float) -> float:
        """Overall stage speedup when ONLY the AI part runs s x faster."""
        f = self.ai_fraction
        return 1.0 / ((1.0 - f) + f / s)

    @property
    def asymptote(self) -> float:
        return 1.0 / (1.0 - self.ai_fraction) if self.ai_fraction < 1 else float("inf")


# paper Fig 8 measurements
INGESTION = StageProfile("ingestion", 0.0)
DETECTION = StageProfile("detection", 0.42)
IDENTIFICATION = StageProfile("identification", 0.88)

# paper §4.3: end-to-end compute-cycle split of Face Recognition
E2E_AI_FRACTION = 0.552
E2E_TAX = {
    "ai": 0.552, "resizing": 0.178, "networking": 0.090,
    "tensor_prep": 0.052, "kafka": 0.036, "other": 0.092,
}


def amdahl_curve(profile: StageProfile, speedups) -> list[tuple[float, float]]:
    return [(s, profile.amdahl_speedup(s)) for s in speedups]


def residual_tax_fraction(profile: StageProfile, s: float) -> float:
    """Fraction of the REMAINING time that is tax after the AI part runs
    s× faster — the paper's central quantity: accelerating the AI makes
    the supporting work dominate. At s→∞ this →1 for any profile with
    ai_fraction < 1."""
    f = profile.ai_fraction
    denom = (1.0 - f) + f / s
    return (1.0 - f) / denom if denom else 0.0


def roofline_sweep(profile: StageProfile, speedups
                   ) -> list[tuple[float, float, float]]:
    """(s, overall Amdahl speedup, residual tax fraction) per point.

    ``profile`` may come from the paper's measured constants OR from a
    measured roofline (:func:`profile_from_roofline`, or
    :meth:`repro_torch.roofline.analysis.Roofline.stage_profile`, which
    ``chip_smoke.py``'s phase 12 feeds in from the H100's terms)."""
    return [(s, profile.amdahl_speedup(s), residual_tax_fraction(profile, s))
            for s in speedups]


def profile_from_roofline(name: str, t_compute: float, t_memory: float,
                          t_collective: float = 0.0) -> StageProfile:
    """A measured Amdahl profile from roofline terms: the compute term is
    the accelerable "AI" share; memory + collective terms are the
    infrastructure tax an accelerator does not shrink."""
    tot = t_compute + t_memory + t_collective
    return StageProfile(name, t_compute / tot if tot else 0.0)


def emulated_times(t_measured: dict[str, float], s: float,
                   ai_only: bool = False,
                   profiles: dict[str, StageProfile] | None = None
                   ) -> dict[str, float]:
    """The paper's §5.2 emulation: stage times / s.

    With ``ai_only=True``, apply Amdahl per stage instead (only the AI
    portion accelerates — §5.1's analytical view)."""
    out = {}
    for stage, t in t_measured.items():
        if ai_only and profiles and stage in profiles:
            out[stage] = t / profiles[stage].amdahl_speedup(s)
        else:
            out[stage] = t / s
    return out
