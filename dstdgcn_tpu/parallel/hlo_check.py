"""Structural verification of the ring schedule's communication overlap.

``dstd_spatial_ring`` (shard.py) is written so that the ``ppermute`` of
round ``r+1`` can travel while round ``r``'s score/mixing/aggregation
matmuls run.  This module checks that against compiled HLO:

``check_overlap(txt)``
    For a SCHEDULED HLO module with asynchronous collectives
    (``compiled.as_text()`` of the ring compiled for GPUs, where XLA emits
    ``collective-permute-start``/``-done`` pairs over NCCL): pairs every
    start with its done and counts the matmul instructions (``dot`` /
    ``convolution``, cuBLAS gemm custom-calls, or fusions calling a
    dot-bearing computation) scheduled strictly between them.  Overlap is
    demonstrated when permute pairs bracket compute: the transfer is in
    flight while the matmuls run.

``check_send_independence(txt)``
    For ANY compiled HLO of the ring (the CPU backend lowers to
    synchronous ``collective-permute``, so no start/done pairs exist):
    verifies the *dataflow* property that makes overlap possible — no
    send depends on any round's score/mixing/aggregation compute.  Each
    permute's ancestor chain (cut at earlier permutes) must contain no
    instruction from the ``knsrvw`` score-mixing einsum, the
    ``kntvc,kntvw`` aggregation einsum, or the tanh scoring
    (shard.py:148-158) — only the up-front q/xf projections feed the
    first send, and later sends chain directly from earlier permutes.
    If this fails, XLA *cannot* overlap, on any backend.

``tests/test_ring_overlap.py`` asserts both on the CPU; ``chip_smoke.py
--four-cards`` runs ``check_overlap`` on the ring's GPU schedule.
"""

from __future__ import annotations

import re
from typing import Dict, List, Set

_OPC = re.compile(
    r"(?<!%)\b(collective-permute-start|collective-permute-done|"
    r"collective-permute|fusion|convolution|dot|custom-call)\(")
_NAME = re.compile(r"^\s+(?:ROOT )?%(\S+) = ")
_COMP_HDR = re.compile(r"^%(\S+) \(.*\) -> .* \{")
_CALLS = re.compile(r"calls=%(\S+?)[,}\s]")
_DONE_OF = re.compile(r"collective-permute-done\(%(\S+?)\)")
#: einsum signatures of per-round compute inside the ring kernel
#: (shard.py:148-158) — sends must never depend on these
_ROUND_COMPUTE = ("knsrvw", "kntvc,kntvw", "tanh")


def _dot_computations(lines: List[str]) -> Set[str]:
    """Names of non-entry computations containing a dot/convolution."""
    out, cur = set(), None
    for line in lines:
        m = _COMP_HDR.match(line)
        if m:
            cur = m.group(1)
        if line.startswith("}"):
            cur = None
        if cur and ("convolution(" in line
                    or re.search(r"(?<!%)\bdot\(", line)):
            out.add(cur)
    return out


def _round_compute_computations(lines: List[str]) -> Set[str]:
    """Names of computations whose body belongs to per-round ring math."""
    out, cur = set(), None
    for line in lines:
        m = _COMP_HDR.match(line)
        if m:
            cur = m.group(1)
        if line.startswith("}"):
            cur = None
        if cur and any(sig in line for sig in _ROUND_COMPUTE):
            out.add(cur)
    return out


def _entry_instructions(lines: List[str]) -> List[Dict]:
    """Ordered instruction records of the ENTRY computation."""
    i0 = next(i for i, line in enumerate(lines) if line.startswith("ENTRY"))
    seq = []
    for line in lines[i0 + 1:]:
        if line.startswith("}"):
            break
        nm = _NAME.match(line)
        if not nm:
            continue
        om = _OPC.search(line)
        calls = _CALLS.search(line)
        seq.append(dict(name=nm.group(1),
                        opcode=om.group(1) if om else "other",
                        calls=calls.group(1) if calls else None,
                        operands=set(re.findall(r"%([\w.\-]+)", line))
                        - {nm.group(1)},
                        line=line))
    return seq


def check_overlap(txt: str) -> Dict:
    """Scheduled-HLO overlap summary (see module docstring)."""
    lines = txt.splitlines()
    assert "is_scheduled=true" in txt, (
        "HLO module is not scheduled; compile for an accelerator to get "
        "the schedule")
    dot_comps = _dot_computations(lines)
    seq = _entry_instructions(lines)
    idx = {s["name"]: i for i, s in enumerate(seq)}

    def is_compute(s):
        return (s["opcode"] in ("dot", "convolution")
                or (s["opcode"] == "custom-call" and "gemm" in s["line"])
                or (s["opcode"] == "fusion" and s["calls"] in dot_comps))

    pairs = []
    for di, s in enumerate(seq):
        if s["opcode"] != "collective-permute-done":
            continue
        start = _DONE_OF.search(s["line"]).group(1)
        si = idx[start]
        between = [seq[j]["name"] for j in range(si + 1, di)
                   if is_compute(seq[j])]
        pairs.append(dict(start=start, done=s["name"], start_idx=si,
                          done_idx=di, compute_between=between))
    return dict(
        num_pairs=len(pairs),
        num_overlapped=sum(1 for p in pairs if p["compute_between"]),
        pairs=pairs,
    )


def check_send_independence(txt: str) -> Dict:
    """Dataflow check: permute ancestors contain no round compute."""
    lines = txt.splitlines()
    round_comps = _round_compute_computations(lines)
    seq = _entry_instructions(lines)
    by_name = {s["name"]: s for s in seq}
    permutes = [s for s in seq if s["opcode"] in (
        "collective-permute", "collective-permute-start")]
    assert permutes, "no collective-permute found in entry computation"

    def is_round_compute(s):
        return (any(sig in s["line"] for sig in _ROUND_COMPUTE)
                or (s["calls"] in round_comps))

    # guard against a vacuous pass: the round-compute signatures are
    # matched via einsum-subscript metadata, which a jax/XLA upgrade or a
    # shard.py refactor could silently stop emitting — require that the
    # module actually contains identifiable round compute
    n_round = sum(1 for s in seq if any(
        sig in s["line"] for sig in _ROUND_COMPUTE) or s["calls"] in
        round_comps)
    assert n_round + len(round_comps) > 0, (
        "no score/mixing/aggregation compute identified in the HLO — "
        "the _ROUND_COMPUTE signatures no longer match; update them "
        "before trusting this check")

    bad = []
    for p in permutes:
        # BFS over ancestors, cutting at other permutes (earlier rounds'
        # transfers are legitimate inputs of later sends)
        stack, seen = list(p["operands"]), set()
        while stack:
            nm = stack.pop()
            if nm in seen or nm not in by_name:
                continue
            seen.add(nm)
            s = by_name[nm]
            if s["opcode"].startswith("collective-permute"):
                continue
            if is_round_compute(s):
                bad.append((p["name"], nm))
                continue
            stack.extend(s["operands"])
    return dict(num_permutes=len(permutes), violations=bad,
                num_round_compute=n_round + len(round_comps))
