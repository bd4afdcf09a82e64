"""Collective-byte accounting and the roofline terms of one step.

The counterpart of the JAX package's ``launch/hlo_analysis.py``; the path
is kept so that a reader finds it.  The JAX package parses the optimized
HLO module's text for its collectives (``parse_collectives``,
``_shape_bytes``, ``_group_size``); the port produces no HLO, so those
parsers have no counterpart here: ``launch/step_stats.py`` reads each
collective's tensors and process group off the ``c10d`` op as the step
runs, under the same wire convention (ring algorithms, per participating
rank):

  all-reduce      2·(n-1)/n · bytes     (reduce-scatter + all-gather phases)
  all-gather      (n-1)/n · result      (operand is the local shard)
  reduce-scatter  (n-1)/n · operand
  all-to-all      (n-1)/n · operand
  collective-permute  1   · operand

Hardware model: the rates are ``Roofline``'s arguments.  Handed the JAX
package's (TPU v5e: 197e12 flop/s, 819e9 B/s, 50e9 B/s a link) it gives
the JAX package's numbers; its defaults are one NVIDIA H100 80GB HBM3 at
700 W (below).  Roofline terms are seconds a step on one rank, each a
floor when handed floors, as the dry-run hands them (``launch/dryrun.py``):

  compute    = flops / peak flop/s (every flop at the bf16 tensor rate)
  memory     = HBM bytes / HBM rate (the dry-run's: ``step_stats``' HBM
               floor, not its eager traffic, which bounds from above)
  collective = wire bytes / link rate, a group's bytes at the rate of its
               slowest hop: NVLink while the group's ranks share a node of
               ``NODE_SIZE``, the network between nodes once they do not
               (on the (16, 16) mesh a "model" group of 16 spans two
               nodes, a "data" group sixteen).
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 80GB HBM3 (SXM), 700 W.  NVIDIA's H100 data sheet, dense
# rates without sparsity: 989 TFLOP/s bf16 on the tensor cores, HBM3 at
# 3.35 TB/s (chip_smoke.py's BF16_FLOPS_PER_S and HBM_BYTES_PER_S), NVLink
# 4 at 900 GB/s a GPU, both directions together: 450e9 B/s each way.
PEAK_FLOPS = 989e12          # bf16 dense / card
HBM_BW = 3.35e12             # bytes/s / card
NVLINK_BW = 450e9            # bytes/s / card, one direction, within a node
# NVIDIA DGX H100 (its user guide): 8 GPUs a node over NVSwitch, and one
# ConnectX-7 400 Gb/s InfiniBand port a GPU between nodes: 50e9 B/s.
NETWORK_BW = 50e9            # bytes/s / card, one direction, across nodes
NODE_SIZE = 8                # cards a node


def crosses_nodes(ranks) -> bool:
    """Whether a group of global ranks (rank r on node r // NODE_SIZE)
    spans more than one node."""
    return len({r // NODE_SIZE for r in ranks}) > 1


@dataclasses.dataclass
class CollectiveStats:
    # raw operand/result bytes and effective wire bytes per device
    by_kind_bytes: dict
    by_kind_wire: dict
    by_group_wire: dict      # group size -> wire bytes
    n_ops: int

    @property
    def total_wire(self) -> float:
        return sum(self.by_kind_wire.values())

    def to_json(self):
        return {
            "bytes_by_kind": dict(self.by_kind_bytes),
            "wire_by_kind": dict(self.by_kind_wire),
            "wire_by_group_size": {str(k): v
                                   for k, v in self.by_group_wire.items()},
            "n_ops": self.n_ops,
            "total_wire_bytes": self.total_wire,
        }


# --------------------------------------------------------------------------
# roofline
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    flops: float             # per device per step
    hbm_bytes: float         # the dry-run's: the step's HBM floor
    wire_bytes: float        # every group's, the cross-node ones included
    model_flops: float       # 6·N·D (train) / 2·N·D (serve), per device
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = NVLINK_BW
    cross_node_wire_bytes: float = 0.0   # the part in groups across nodes
    cross_node_bw: float = NETWORK_BW

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return ((self.wire_bytes - self.cross_node_wire_bytes) / self.link_bw
                + self.cross_node_wire_bytes / self.cross_node_bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        """Perfect-overlap lower bound: max of the three terms (a lower
        bound on the step's time while each term is a floor)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / step flops — remat/redundancy waste detector."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU at the perfect-overlap step time."""
        if self.step_time == 0:
            return 0.0
        return (self.model_flops / self.peak_flops) / self.step_time

    def to_json(self):
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "wire_bytes_per_device": self.wire_bytes,
            "model_flops_per_device": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_lb_s": self.step_time,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_per_device(cfg, kind: str, global_batch: int, seq_len: int,
                           n_chips: int) -> float:
    """6·N_active·D for train, 2·N_active·D for serve (decode: D = one
    token per sequence), split evenly over chips.  Attention score FLOPs
    (12·L·d·s per token at full attention) are added for completeness —
    they matter at 32k."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = global_batch * seq_len
        factor = 6.0
        attn_ctx = seq_len
    elif kind == "prefill":
        tokens = global_batch * seq_len
        factor = 2.0
        attn_ctx = seq_len
    else:  # decode: one new token against a seq_len cache
        tokens = global_batch * 1
        factor = 2.0
        attn_ctx = seq_len
    core = factor * n_active * tokens
    # causal attention: 2·2·(ctx/2)·(nq·hd)·L per token fwd, ×3 with bwd
    if cfg.family not in ("ssm",):
        n_attn = cfg.n_layers
        if cfg.is_hybrid and cfg.hybrid_every:
            n_attn = cfg.n_layers // cfg.hybrid_every   # shared-block only
        if cfg.n_enc_layers:
            n_attn = cfg.n_layers + cfg.n_enc_layers    # enc self + dec
        att = (2 * 2 * (attn_ctx / 2) * cfg.n_heads * cfg.head_dim
               * n_attn * tokens)
        core += att * (3.0 if kind == "train" else 1.0)
    return core / n_chips
