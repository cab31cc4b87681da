"""TCO model: homogeneous vs purpose-built edge data center (paper §7).

Reproduces Tables 3 and 4 item-for-item, plus the power/cooling model and
3-year amortization, yielding the paper's headline: the purpose-built,
AI-tax-aware design supports 32x accelerated AI at ~16.6% lower TCO.

The port's copy of ``repro.core.tco``, the same in behaviour: one seed
gives the same numbers in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Item:
    name: str
    unit_price: float
    quantity: int

    @property
    def cost(self) -> float:
        return self.unit_price * self.quantity


@dataclass
class DataCenterDesign:
    name: str
    items: tuple
    server_count: int
    switch_count: int
    server_watts: float = 750.0
    switch_watts: float = 398.0          # Mellanox SN2700 max
    cooling_overhead: float = 1.0        # cooling ~= IT power (paper cites)
    kwh_price: float = 0.10
    amortization_years: float = 3.0

    @property
    def equipment_cost(self) -> float:
        return sum(i.cost for i in self.items)

    @property
    def power_kw(self) -> float:
        it = (self.server_count * self.server_watts
              + self.switch_count * self.switch_watts) / 1000.0
        return it * (1.0 + self.cooling_overhead)

    @property
    def yearly_power_cost(self) -> float:
        return self.power_kw * self.kwh_price * 24 * 365

    @property
    def yearly_tco(self) -> float:
        return (self.equipment_cost / self.amortization_years
                + self.yearly_power_cost)


def homogeneous_design(n_nodes: int = 1024,
                       drives_per_node: int = 1) -> DataCenterDesign:
    """Table 3: every node identical (plus optional extra NVMe per node,
    the 'maintain homogeneity' option for 32x support — +US$1.23M)."""
    n_switches = 160
    items = (
        Item("Dell PowerEdge R740xd (base server, 2x Xeon 8176, 384GB)",
             28_731, n_nodes),
        Item("Intel SSD DC P4510 1TB", 399, n_nodes * drives_per_node),
        Item("Mellanox MCX415A 100GbE adapter", 660, n_nodes),
        Item("Mellanox MSN2700-CS2F 100GbE switch", 17_285, n_switches),
        Item("Mellanox MCP1600 100GbE cable", 100, 3 * n_nodes),
    )
    return DataCenterDesign("homogeneous", items, n_nodes, n_switches)


def purpose_built_design() -> DataCenterDesign:
    """Table 4: 867 compute nodes (10GbE, no NVMe) + 157 broker nodes
    (cheap CPUs, 4x NVMe, 50GbE) + tiered fat-tree of 28x100GbE +
    14x40GbE switches with splitter cables."""
    items = (
        Item("Dell PowerEdge R740xd (compute, 2x Xeon 8176)", 28_731, 867),
        Item("Mellanox MCX411A 10GbE adapter", 180, 867),
        Item("Dell PowerEdge R740xd (broker, 2x Xeon Bronze 3104)", 11_016, 157),
        Item("Mellanox MCX413A 50GbE adapter", 395, 157),
        Item("Intel SSD DC P4510 1TB (4 per broker)", 399, 157 * 4),
        Item("Mellanox MSN2700-CS2F 100GbE switch", 17_285, 28),
        Item("Mellanox MSN2700-BS2F 40GbE switch", 10_635, 14),
        Item("Mellanox MFA7A20-C010 optical splitter 100->2x50", 1_165, 7),
        Item("Mellanox MC2609130-003 copper splitter 40->4x10", 90, 217),
        Item("Mellanox MCP7H00-G002R copper splitter 100->2x50", 140, 79),
        Item("Mellanox MFA1A00-C030 optical 100GbE interconnect", 515, 192),
    )
    return DataCenterDesign("purpose_built", items, 867 + 157, 28 + 14)


@dataclass
class TCOComparison:
    homogeneous: DataCenterDesign
    purpose_built: DataCenterDesign

    @property
    def saving_fraction(self) -> float:
        h, p = self.homogeneous.yearly_tco, self.purpose_built.yearly_tco
        return (h - p) / h

    def summary(self) -> dict:
        def row(d: DataCenterDesign) -> dict:
            return {"equipment": d.equipment_cost,
                    "yearly_power": d.yearly_power_cost,
                    "power_kw": d.power_kw,
                    "yearly_tco": d.yearly_tco}
        return {"homogeneous": row(self.homogeneous),
                "purpose_built": row(self.purpose_built),
                "tco_saving_fraction": self.saving_fraction}


def paper_comparison(support_32x: bool = True) -> TCOComparison:
    """The paper's comparison: homogeneous needs 4 drives/node (or 2.7x
    brokers) to survive 32x acceleration; purpose-built handles it by
    design."""
    return TCOComparison(
        homogeneous=homogeneous_design(drives_per_node=4 if support_32x else 1),
        purpose_built=purpose_built_design())


def provision_drives(target_speedup: float,
                     knee_by_drives: dict[int, float],
                     tolerance: float = 0.0) -> int:
    """Smallest drives/node whose MEASURED knee supports the target S.

    ``knee_by_drives`` maps drive count -> destabilization S observed by
    an executed run (DES sweep or the live cluster,
    ``repro_torch.cluster.crossval``) — not a paper constant. ``tolerance``
    admits a knee within that relative margin below the target
    (measured knees carry finite bisection resolution; the paper's
    "4 drives supports 32x" sits exactly ON the modeled knee, so a
    resolution-sized margin is part of reading the measurement).
    Raises if no measured configuration reaches the target, rather
    than silently under-provisioning.
    """
    floor = target_speedup * (1.0 - tolerance)
    ok = [d for d, knee in sorted(knee_by_drives.items()) if knee >= floor]
    if not ok:
        raise ValueError(
            f"no measured configuration sustains S={target_speedup}: "
            f"{knee_by_drives}")
    return ok[0]


def measured_comparison(target_speedup: float,
                        knee_by_drives: dict[int, float],
                        n_nodes: int = 1024,
                        tolerance: float = 0.0) -> TCOComparison:
    """Tables 3/4 driven by executed measurements.

    The homogeneous design's per-node drive count is chosen by
    :func:`provision_drives` from measured knees instead of the paper's
    "4 drives for 32x" constant; the purpose-built design already
    carries 4 drives per broker node by construction. When the
    measurements agree with the paper (they do — see
    ``benchmarks/fig_cluster_scaling.py``) this reproduces
    ``paper_comparison`` from first principles.
    """
    d = provision_drives(target_speedup, knee_by_drives, tolerance)
    return TCOComparison(
        homogeneous=homogeneous_design(n_nodes=n_nodes, drives_per_node=d),
        purpose_built=purpose_built_design())
