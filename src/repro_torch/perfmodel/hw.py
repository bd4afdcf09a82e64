"""Hardware profiles for the Appendix-A performance model.

PLASTICINE reproduces the paper's evaluation platform (§6.1/§6.2): U=64
PMU/PCU pairs, SIMD width L=16, 16 MB scratchpad, DDR3 at 49 GB/s, SSD
spill at 700 MB/s, 12.3 TFLOPS peak, 1 GHz, worst-case on-chip network
latency 24 cycles + 6-cycle PCU pipeline.

TPU_V5E maps the same roles onto one v5e chip for the beyond-paper
analysis: the PMU grid becomes VMEM tiles (128 MB), the PCU SIMD becomes
the 8×128 VPU lane grid, DRAM becomes HBM at 819 GB/s; "SSD spill"
becomes host DMA (~50 GB/s PCIe-class).  `scale(n)` models an n-chip pod
(joins scale linearly in both lanes and aggregate bandwidth; the ICI
collective term of the distributed join is measured separately by the
dry-run, not assumed here).

CPU_XEON models the paper's baseline (§6.1): single-threaded hash join on
a Xeon E5-2697v2 — one comparison chain per cycle-ish with a calibrated
per-probe cost, DDR3 DRAM, 251 GB RAM before SSD spill.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HW:
    name: str
    freq: float                  # Hz
    u: int                       # parallel compute units (PMU/PCU pairs)
    simd: int                    # lanes per unit
    dram_bw: float               # bytes/s
    dram_resp_s: float           # per-request response time (latency)
    dram_burst: int              # bytes per efficient burst
    spill_bw: float              # bytes/s once DRAM capacity is exceeded
    dram_cap: float              # bytes of DRAM before spill
    sram: float                  # on-chip memory bytes (usable: /2 for
                                 # double buffering per §6.2)
    net_lat_cycles: int = 24     # worst-case diagonal network latency
    pipe_lat_cycles: int = 6     # PCU pipeline latency
    tuple_bytes: int = 8         # two 4-byte ints (paper Example 3)
    cpu_probe_s: float = 0.0     # CPU-only: seconds per compare/probe

    @property
    def lanes(self) -> int:
        return self.u * self.simd

    @property
    def m_tuples(self) -> float:
        """On-chip memory budget in tuples with double buffering (§6.2:
        'uses only half of the on-chip memory')."""
        return self.sram / 2 / self.tuple_bytes

    def scaled(self, n_chips: int) -> "HW":
        return dataclasses.replace(
            self, name=f"{self.name}x{n_chips}",
            u=self.u * n_chips, dram_bw=self.dram_bw * n_chips,
            sram=self.sram * n_chips, dram_cap=self.dram_cap * n_chips)


PLASTICINE = HW(
    name="plasticine", freq=1e9, u=64, simd=16,
    dram_bw=49e9, dram_resp_s=60e-9, dram_burst=64,
    spill_bw=0.7e9, dram_cap=251e9, sram=16e6)

TPU_V5E = HW(
    name="tpu-v5e", freq=0.94e9, u=8, simd=128,       # VPU lane grid
    dram_bw=819e9, dram_resp_s=120e-9, dram_burst=512,
    spill_bw=50e9, dram_cap=16e9, sram=128e6)

CPU_XEON = HW(
    name="cpu-xeon-e5", freq=2.7e9, u=1, simd=1,
    dram_bw=50e9, dram_resp_s=80e-9, dram_burst=64,
    spill_bw=0.7e9, dram_cap=251e9, sram=30e6,
    cpu_probe_s=3e-9)            # calibrated hash-probe cost (§6.3 note)
