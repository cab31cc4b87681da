"""Cross-calibration of :mod:`repro_torch.roofline.op_cost` against
``torch.utils.flop_counter.FlopCounterMode`` (counterpart of
``repro.roofline.calibrate``, which holds its HLO walk against XLA's
``cost_analysis()``).

The harness runs a battery of fixture programs (a matmul, a 7-step scan, a
3 x 5 nested scan, an in-place slice-write carry, an attention block: the
shapes the roofline terms are built from) twice: under
:func:`~repro_torch.roofline.op_cost.counting`, which traces one trip of
each loop and multiplies it, with ``FlopCounterMode`` on the same run
(which then sees each loop body once), and on real tensors under
``FlopCounterMode`` alone, every trip executed. The gate compares op_cost's
trip-multiplied dot FLOPs with the second: they agree only if the trips
are multiplied right. ``FlopCounterMode`` counts products and
convolutions, no elementwise op and no byte, so those terms are reported,
not gated.

``python -m repro_torch.roofline.calibrate [--tolerance 0.05]`` prints the
table and exits non-zero when a gated fixture is off by more than the
tolerance; ``tests/test_torch_roofline.py`` gates the battery at 5%.
"""
from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, field

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.roofline import op_cost


def _matmul(make):
    return make(32, 64) @ make(64, 128)


def _scan(make):
    xs, w = make(7, 8, 16), make(16, 16)

    def body(t, c):
        c = torch.tanh(c @ w) + xs[t]
        return c, None
    return op_cost.scan(body, xs[0], 7)[0]


def _nested_scan(make):
    xs, w = make(3, 5, 8, 8), make(8, 8)

    def outer(i, c):
        return op_cost.scan(lambda j, ci: (ci @ w, None), c, 5)[0], None
    return op_cost.scan(outer, xs[0, 0], 3)[0]


def _dus_carry(make):
    buf, xs = make(16, 1024), make(16, 1024)

    def body(i, b):
        b[i] = xs[i]
        return b, None
    return op_cost.scan(body, buf, 16)[0]


def _attention(make):
    from repro_torch.kernels import ops
    return ops.attention(make(2, 128, 4, 32), make(2, 128, 2, 32),
                         make(2, 128, 2, 32), causal=True)


@dataclass(frozen=True)
class Fixture:
    name: str
    build: object                   # (make) -> output; make(*shape) -> tensor
    gate: str = "dot_flops"         # term the 5% gate applies to ("" = none)
    note: str = ""


FIXTURES = (
    Fixture("matmul", _matmul, note="single product, no loop"),
    Fixture("scan", _scan, note="7 trips, product + tanh body"),
    Fixture("nested_scan", _nested_scan, note="3 trips x 5 trips"),
    Fixture("dus_carry", _dus_carry, gate="",
            note="in-place slice-write carry; no product, bytes fixture"),
    Fixture("attention", _attention,
            note="the plain attention: qk/av products + softmax"),
)


@dataclass
class CalibRow:
    name: str
    gate: str
    note: str
    ours: dict = field(default_factory=dict)       # trip-multiplied terms
    ours_flat: dict = field(default_factory=dict)  # each loop body once
    lib: dict = field(default_factory=dict)        # FlopCounterMode's
    deltas: dict = field(default_factory=dict)     # relative, vs lib

    @property
    def gate_delta(self) -> float | None:
        if not self.gate:
            return None
        return self.deltas.get(self.gate)

    def ok(self, tolerance: float = 0.05) -> bool:
        d = self.gate_delta
        return d is None or abs(d) <= tolerance


def _rel(ours: float, theirs: float) -> float:
    if theirs == 0.0:
        return 0.0 if ours == 0.0 else float("inf")
    return (ours - theirs) / theirs


def calibrate_one(fx: Fixture) -> CalibRow:
    same_run = FlopCounterMode(display=False)
    with op_cost.counting(same_run) as counter:
        fx.build(lambda *shape: torch.empty(shape))
    full = FlopCounterMode(display=False)
    gen = torch.Generator().manual_seed(0)
    with full:
        fx.build(lambda *shape: torch.randn(shape, generator=gen))
    row = CalibRow(name=fx.name, gate=fx.gate, note=fx.note)
    tripped, flat = counter.cost, counter.flat
    row.ours = {"dot_flops": tripped.dot_flops, "flops": tripped.flops,
                "bytes": tripped.hbm_bytes}
    row.ours_flat = {"dot_flops": flat.dot_flops, "flops": flat.flops,
                     "bytes": flat.hbm_bytes}
    row.lib = {"flops": float(full.get_total_flops()),
               "flops_flat": float(same_run.get_total_flops())}
    row.deltas = {"dot_flops": _rel(tripped.dot_flops, row.lib["flops"]),
                  "dot_flops_flat": _rel(flat.dot_flops,
                                         row.lib["flops_flat"])}
    return row


def calibrate(fixtures=FIXTURES) -> list:
    return [calibrate_one(fx) for fx in fixtures]


def report(rows, tolerance: float = 0.05) -> list:
    """Human-readable per-term table (one string per line)."""
    out = [f"{'fixture':<12} {'ours(dot)':>12} {'lib(flops)':>12} "
           f"{'d_dot':>8} {'ours(flops)':>12} {'ours(B)':>12}  gate"]
    for r in rows:
        verdict = "-" if not r.gate else \
            ("OK" if r.ok(tolerance) else "FAIL")
        out.append(
            f"{r.name:<12} {r.ours['dot_flops']:>12.4g} "
            f"{r.lib['flops']:>12.4g} {r.deltas['dot_flops']:>+8.1%} "
            f"{r.ours['flops']:>12.4g} {r.ours['bytes']:>12.4g}  {verdict}")
        if r.ours["flops"] != r.ours_flat["flops"]:
            mult = (r.ours["flops"] / r.ours_flat["flops"]
                    if r.ours_flat["flops"] else 0.0)
            out.append(f"{'':<12} one trip: flops={r.ours_flat['flops']:.4g} "
                       f"bytes={r.ours_flat['bytes']:.4g} (x{mult:.1f} "
                       f"multiplied; FlopCounterMode on the same run "
                       f"{r.lib['flops_flat']:.4g})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tolerance", type=float, default=0.05,
                    help="max |relative dot-FLOP delta| on gated fixtures")
    args = ap.parse_args(argv)
    rows = calibrate()
    for line in report(rows, tolerance=args.tolerance):
        print(line)
    bad = [r.name for r in rows if not r.ok(args.tolerance)]
    if bad:
        print(f"calibrate: FAIL — dot-FLOP delta > {args.tolerance:.0%} on: "
              + ", ".join(bad), file=sys.stderr)
        return 1
    gated = sum(1 for r in rows if r.gate)
    print(f"calibrate: OK ({gated}/{len(rows)} fixtures gated at "
          f"{args.tolerance:.0%}, all within tolerance)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
