"""E-graph invariant checking (pass 2).

Validates the representation invariants the egg design relies on —
after ``run_rules`` and after a cache ``graft_choice``, both of which
end in ``rebuild()``:

* **union-find** — parent pointers are in range and converge (no
  cycles), and every key of ``classes`` is its own canonical root;
* **hashcons / congruence closure** — every hash-consed node's
  canonical form is present and maps into the same class, every node
  stored in a class hash-conses back into that class, and no two
  distinct classes contain the same canonical node (two congruent
  nodes in different classes = congruence closure broken);
* **analysis consistency** — a class whose constant analysis folded
  must actually contain that constant node, an ``array`` symbol class
  must carry the declared :class:`~repro_torch.analysis.opstats.ArrayInfo`
  (dtype mismatch is an error; shape disagreement after a merge is a
  warning, since merges keep the root's description by design), and a
  ``load`` class's ainfo must dtype-agree with what query-time
  inference derives.

Exposed as :meth:`repro_torch.core.egraph.EGraph.check_invariants`.
"""
from __future__ import annotations

from typing import Dict, List

from .findings import PASS_EGRAPH, Finding


def check_egraph(eg) -> List[Finding]:
    """All invariant violations of ``eg`` (empty list = consistent)."""
    out: List[Finding] = []
    n = len(eg.uf.parent)

    # -- union-find structure ----------------------------------------------
    for x in range(n):
        node, steps = x, 0
        while eg.uf.parent[node] != node:
            p = eg.uf.parent[node]
            if not (0 <= p < n):
                out.append(Finding(
                    PASS_EGRAPH, "error", "uf-out-of-range",
                    f"parent[{node}] = {p} outside [0, {n})",
                    subject=str(x)))
                return out
            node, steps = p, steps + 1
            if steps > n:
                out.append(Finding(
                    PASS_EGRAPH, "error", "uf-cycle",
                    f"parent chain from {x} does not converge",
                    subject=str(x)))
                return out

    if eg.pending:
        out.append(Finding(
            PASS_EGRAPH, "info", "rebuild-pending",
            f"{len(eg.pending)} merges await rebuild(); congruence "
            f"checks reflect the pre-rebuild state"))

    for cid in eg.classes:
        if eg.find(cid) != cid:
            out.append(Finding(
                PASS_EGRAPH, "error", "non-canonical-class",
                f"classes[{cid}] is not its own root "
                f"(find → {eg.find(cid)})", subject=str(cid)))

    # -- hashcons ----------------------------------------------------------
    for node, cid in eg.hashcons.items():
        if not (0 <= cid < n) or any(not (0 <= ch < n)
                                     for ch in node.children):
            out.append(Finding(
                PASS_EGRAPH, "error", "hashcons-out-of-range",
                f"{node!r} → {cid} references ids outside [0, {n})",
                subject=repr(node)))
            continue
        canon = eg.canonicalize(node)
        mapped = eg.hashcons.get(canon)
        if mapped is None:
            out.append(Finding(
                PASS_EGRAPH, "error", "hashcons-stale",
                f"canonical form {canon!r} of hash-consed {node!r} is "
                f"not hash-consed", subject=repr(node)))
        elif eg.find(mapped) != eg.find(cid):
            out.append(Finding(
                PASS_EGRAPH, "error", "hashcons-inconsistent",
                f"{node!r} → class {eg.find(cid)} but its canonical "
                f"form → class {eg.find(mapped)}", subject=repr(node)))

    # -- class membership + congruence closure -----------------------------
    canon_owner: Dict[object, int] = {}
    for cid, ec in eg.eclasses().items():
        for node in ec.nodes:
            if any(not (0 <= ch < n) for ch in node.children):
                out.append(Finding(
                    PASS_EGRAPH, "error", "node-out-of-range",
                    f"{node!r} in class {cid} has out-of-range children",
                    subject=str(cid)))
                continue
            canon = eg.canonicalize(node)
            h = eg.hashcons.get(canon)
            if h is None:
                out.append(Finding(
                    PASS_EGRAPH, "error", "unhashconsed-member",
                    f"{canon!r} is in class {cid} but not hash-consed",
                    subject=str(cid)))
            elif not (0 <= h < n):
                pass  # already reported as hashcons-out-of-range above
            elif eg.find(h) != cid:
                out.append(Finding(
                    PASS_EGRAPH, "error", "member-maps-elsewhere",
                    f"{canon!r} sits in class {cid} but hash-conses to "
                    f"class {eg.find(h)}", subject=str(cid)))
            owner = canon_owner.get(canon)
            if owner is not None and owner != cid:
                out.append(Finding(
                    PASS_EGRAPH, "error", "congruence-violation",
                    f"congruent node {canon!r} appears in distinct "
                    f"classes {owner} and {cid}", subject=repr(canon)))
            canon_owner[canon] = cid

        # -- constant-folding analysis ------------------------------------
        if eg.enable_const_fold and ec.data is not None:
            if not any(m.op == "const" and m.payload == ec.data
                       and type(m.payload) is type(ec.data)
                       for m in ec.nodes):
                out.append(Finding(
                    PASS_EGRAPH, "error", "data-without-const",
                    f"class {cid} folded to {ec.data!r} but contains no "
                    f"matching const node", subject=str(cid)))

        # -- array-operand (ainfo) analysis -------------------------------
        for node in ec.nodes:
            if node.op == "array":
                declared = eg.array_info.get(eg._array_base(node.payload))
                if declared is None:
                    continue
                if ec.ainfo is None:
                    out.append(Finding(
                        PASS_EGRAPH, "error", "ainfo-missing",
                        f"array class {cid} ({node.payload}) lost its "
                        f"declared operand info", subject=str(node.payload)))
                elif ec.ainfo.dtype != declared.dtype:
                    out.append(Finding(
                        PASS_EGRAPH, "error", "ainfo-dtype-mismatch",
                        f"array class {cid} ({node.payload}) carries "
                        f"dtype {ec.ainfo.dtype} vs declared "
                        f"{declared.dtype}", subject=str(node.payload)))
                elif ec.ainfo.shape != declared.shape:
                    out.append(Finding(
                        PASS_EGRAPH, "warning", "ainfo-shape-mismatch",
                        f"array class {cid} ({node.payload}) carries "
                        f"shape {ec.ainfo.shape} vs declared "
                        f"{declared.shape} (merge kept the root's "
                        f"description)", subject=str(node.payload)))
            elif node.op == "load" and ec.ainfo is not None:
                inferred = eg.load_operand_info(eg.canonicalize(node))
                if inferred is not None and \
                        inferred.dtype != ec.ainfo.dtype:
                    out.append(Finding(
                        PASS_EGRAPH, "warning", "load-ainfo-drift",
                        f"load class {cid} carries dtype "
                        f"{ec.ainfo.dtype} but query-time inference "
                        f"gives {inferred.dtype}", subject=str(cid)))
    return out
