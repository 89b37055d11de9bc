"""CostModel: what one engine step costs, as a function of pack shape.

The ragged single-program step is what makes this model small:
every launch — prefill chunks, plain decode rows, verify windows —
rides ONE program whose work scales with the ragged token count it
packs, so per-step cost collapses to a base + per-token line plus a
small host-side overhead that doesn't scale with the pack.  The model
is therefore three scalars and one refinement table:

    step_base_s        intercept of total step wall time vs packed
                       tokens (device launch + fixed host work)
    step_per_token_s   slope: marginal wall seconds per packed token
    host_per_step_s    the host-only share of a step (schedule/pack/
                       stage/sample/retire + dispatch) — the part a
                       K-step decode window amortizes
    decode_table       median TOTAL step seconds for pure-decode steps
                       keyed by row count: the exact shapes the fleet
                       spends most of its life in, measured directly
                       instead of read off the regression line
    active_frac        the engine-ACTIVE share of a step span: the
                       real engine stamps ITL samples with
                       ``dispatch_s + block_s`` (host packing plus the
                       residual completion block), NOT the launch-to-
                       launch cadence — async overlap hides device time
                       under prestage, and commit/retire fall outside
                       the stamped duration.  Simulated ITL samples are
                       step cost x active_frac so simulated percentiles
                       land on the same scale ServingStats reports;
                       virtual TIME still advances by the full cost
                       (cadence is what throughput and TTFT feel)

Calibration is ``tools/perf/step_timeline.py --fit``: it joins each
``engine.step`` span with its ``engine.pack`` args (tokens, rows) from
a recorded trace, fits the line by least squares, tabulates pure-decode
medians (tokens == rows), and measures host share from the host-phase
spans.  The result is ``sim_calibration.json`` — ``from_json`` here is
its exact mirror.  ``default()`` ships coarse CPU-backend numbers so
the simulator runs uncalibrated (policy COMPARISONS are still
meaningful; absolute latencies are not).

Packed-token accounting matches the engine's ragged pack: a prefill
chunk contributes its chunk length, a plain decode row contributes 1,
a verify row contributes k+1 (drafts + bonus position).
"""
from __future__ import annotations

import json

__all__ = ["CostModel"]


class CostModel:
    """Per-step cost model; all times in (virtual) seconds."""

    def __init__(self, *, step_base_s: float, step_per_token_s: float,
                 host_per_step_s: float, decode_table=None, meta=None,
                 active_frac: float = 1.0,
                 restore_page_s: float = 2e-5):
        self.step_base_s = float(step_base_s)
        self.step_per_token_s = float(step_per_token_s)
        self.host_per_step_s = float(host_per_step_s)
        self.active_frac = min(max(float(active_frac), 0.0), 1.0) or 1.0
        # host->HBM cost of restoring ONE spilled KV page at a step
        # boundary (the spill tier's drain): a host-side slice plus a
        # device write, so roughly a PCIe-bandwidth term, not a compute
        # one.  Charged per restored page by SimReplica; the A/B it
        # feeds is restore-cost-vs-re-prefill-cost.
        self.restore_page_s = float(restore_page_s)
        # {rows -> total step seconds} for pure-decode packs
        self.decode_table = {int(k): float(v)
                             for k, v in (decode_table or {}).items()}
        self.meta = dict(meta or {})

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def default(cls) -> "CostModel":
        """Uncalibrated CPU-backend ballpark (tiny smoke model).  Good
        enough for policy A/Bs on synthetic workloads; run the fit for
        anything that needs absolute numbers."""
        return cls(step_base_s=8e-3, step_per_token_s=6e-5,
                   host_per_step_s=2.5e-3, decode_table={},
                   meta={"source": "default"})

    @classmethod
    def from_dict(cls, d: dict) -> "CostModel":
        return cls(step_base_s=d["step_base_s"],
                   step_per_token_s=d["step_per_token_s"],
                   host_per_step_s=d["host_per_step_s"],
                   decode_table=d.get("decode_table", {}),
                   meta=d.get("meta", {}),
                   active_frac=d.get("active_frac", 1.0),
                   restore_page_s=d.get("restore_page_s", 2e-5))

    @classmethod
    def from_json(cls, path: str) -> "CostModel":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        return {
            "step_base_s": self.step_base_s,
            "step_per_token_s": self.step_per_token_s,
            "host_per_step_s": self.host_per_step_s,
            "active_frac": self.active_frac,
            "restore_page_s": self.restore_page_s,
            "decode_table": {str(k): v
                             for k, v in sorted(self.decode_table.items())},
            "meta": self.meta,
        }

    # ------------------------------------------------------------------
    # the model
    # ------------------------------------------------------------------

    def step_cost(self, packed_tokens: int, *, pure_decode_rows: int = 0
                  ) -> float:
        """Wall seconds for one engine step packing ``packed_tokens``
        ragged tokens.  A pure-decode pack (``pure_decode_rows`` rows,
        one token each) prefers the measured table entry for that exact
        row count when the calibration recorded one."""
        if (pure_decode_rows and packed_tokens == pure_decode_rows
                and pure_decode_rows in self.decode_table):
            return self.decode_table[pure_decode_rows]
        return self.step_base_s + self.step_per_token_s * int(packed_tokens)

    def window_cost(self, rows: int, k: int) -> float:
        """One K-step device-resident decode window over ``rows`` rows:
        K iterations of device work, ONE host round trip.  This is
        exactly the saving the window exists to buy — (K-1) host
        overheads — so the model charges k x (per-step cost minus host
        share) + one host share."""
        per_step = self.step_cost(rows, pure_decode_rows=rows)
        device = max(per_step - self.host_per_step_s, 0.0)
        return self.host_per_step_s + max(int(k), 1) * device

    def prefill_tokens_per_s(self) -> float:
        """Coarse prefill bandwidth estimate (used by admission-shed
        feasibility predictions, never by the step loop itself)."""
        return 1.0 / self.step_per_token_s if self.step_per_token_s else 1e9
