"""Graph-IR rewrite passes (port of ``deeplearning4j_tpu/autodiff/rewrites.py``;
every pass and its counts are the reference's).

The analogue of the reference's platform-helper dispatch
(``libnd4j/include/ops/declarable/platform/cudnn/**`` shadowing generic
op math at execution time): instead of a per-call helper seam, the
imported graph is rewritten ONCE — a
``matmul(transpose_b) → [scale] → [+bias] → softmax → matmul``
chain collapses into a single ``fused_attention`` node, which lowers to
the flash-attention kernels (K3/K4 forward, K5/K6 backward; O(t)
memory).  This is what connects a TF-imported BERT encoder to the hand
kernels: after ``fuse_attention(sd)`` the fine-tune path executes flash
attention instead of materializing [t, t] score matrices.  An ONNX
attention block (``transpose`` + ``matmul``) does not match, in either
package.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_torch.autodiff.samediff import OpNode, SameDiff

log = logging.getLogger("deeplearning4j_torch.rewrites")

# Ops that may sit between the softmax and the PV matmul without
# changing inference semantics (imported dropout freezes to identity).
# NOT stop_gradient — removing it would change gradients.
_PASSTHROUGH = ("identity", "dropout")


def _scalar_const(sd: SameDiff, name: str) -> Optional[float]:
    """Host value of `name` when it is a scalar CONSTANT, else None."""
    var = sd.vars.get(name)
    if var is None or var.var_type != "CONSTANT":
        return None
    val = np.asarray(sd.values.get(name))
    if val.size != 1:
        return None
    return float(val.reshape(()))


class _Maps:
    def __init__(self, sd: SameDiff):
        self.produced_by: Dict[str, int] = {
            o: i for i, n in enumerate(sd.ops) for o in n.outputs}
        self.consumers: Dict[str, List[int]] = {}
        for i, n in enumerate(sd.ops):
            for inp in n.inputs:
                self.consumers.setdefault(inp, []).append(i)
        consumed = set(self.consumers)
        self.graph_outputs = {o for n in sd.ops for o in n.outputs
                              if o not in consumed}


def _single_consumer(maps: _Maps, sd: SameDiff, name: str) -> bool:
    return (len(maps.consumers.get(name, [])) == 1
            and name not in maps.graph_outputs
            and name not in sd.loss_variables)


def _match_scores(sd: SameDiff, maps: _Maps, cur: str, allow_bias: bool,
                  depth: int = 0
                  ) -> Optional[Tuple[str, str, Optional[float],
                                      Optional[str], List[int]]]:
    """Match ``cur`` (the softmax input) as
    ``[+scalar]* [+bias]? [*scale]* matmul(q, k, transpose_b=True)``.

    Scalar-constant adds are softmax-invariant and dropped.  A tensor
    add (the additive padding mask) is only legal ABOVE all scales —
    below a scale the fused formula ``softmax(qk*scale + bias)`` would
    mis-scale it.  Returns (q, k, scale, bias, chain_op_indices)."""
    if depth > 8:
        return None
    pi = maps.produced_by.get(cur)
    if pi is None or not _single_consumer(maps, sd, cur):
        return None
    p = sd.ops[pi]
    if p.op_name == "matmul":
        if p.attrs.get("transpose_a", False) or \
                not p.attrs.get("transpose_b", False):
            return None
        return p.inputs[0], p.inputs[1], None, None, [pi]
    if p.op_name in ("mul", "div"):
        c = _scalar_const(sd, p.inputs[1])
        side = p.inputs[0]
        if c is None:
            if p.op_name == "div":
                return None          # div by tensor: not a scale
            c = _scalar_const(sd, p.inputs[0])
            side = p.inputs[1]
            if c is None:
                return None
        f = (1.0 / c) if p.op_name == "div" else c
        sub = _match_scores(sd, maps, side, False, depth + 1)
        if sub is None:
            return None
        q, k, scale, bias, chain = sub
        scale = f if scale is None else scale * f
        return q, k, scale, bias, chain + [pi]
    if p.op_name == "add":
        c0 = _scalar_const(sd, p.inputs[0])
        c1 = _scalar_const(sd, p.inputs[1])
        if c0 is not None or c1 is not None:
            cont = p.inputs[1] if c0 is not None else p.inputs[0]
            sub = _match_scores(sd, maps, cont, allow_bias, depth + 1)
            if sub is None:
                return None
            q, k, scale, bias, chain = sub
            return q, k, scale, bias, chain + [pi]
        if not allow_bias:
            return None
        matches = []
        for cont, bias_side in ((p.inputs[0], p.inputs[1]),
                                (p.inputs[1], p.inputs[0])):
            sub = _match_scores(sd, maps, cont, False, depth + 1)
            if sub is not None:
                matches.append((sub, bias_side))
        if len(matches) != 1:        # no match, or ambiguous: skip
            return None
        (q, k, scale, _, chain), bias = matches[0]
        return q, k, scale, bias, chain + [pi]
    return None


def _match_pv(sd: SameDiff, maps: _Maps, sm_out: str
              ) -> Optional[Tuple[int, List[int]]]:
    """Follow single-consumer identity/dropout from the softmax output
    to a ``matmul(probs, v)``.  Returns (matmul_idx, passthrough_idxs)."""
    drop: List[int] = []
    cur = sm_out
    for _ in range(4):
        cons = maps.consumers.get(cur, [])
        if len(cons) != 1 or not _single_consumer(maps, sd, cur):
            return None
        n = sd.ops[cons[0]]
        if n.op_name in _PASSTHROUGH:
            drop.append(cons[0])
            cur = n.outputs[0]
            continue
        if n.op_name == "matmul" and n.inputs[0] == cur and \
                not n.attrs.get("transpose_a", False) and \
                not n.attrs.get("transpose_b", False):
            return cons[0], drop
        return None
    return None


def _struct_key(sd: SameDiff, maps: _Maps, name: str, depth: int = 8):
    """Structural fingerprint of the subgraph producing ``name``:
    equal keys => provably equal values.  CONSTANT leaves compare by
    VALUE (TF's Tensordot emits per-branch copies of the same perm /
    shape consts); VARIABLE / placeholder / depth-cut leaves compare by
    name."""
    var = sd.vars.get(name)
    if var is not None and var.var_type == "CONSTANT":
        v = np.asarray(sd.values[name])
        return ("const", v.dtype.str, v.shape, v.tobytes())
    pi = maps.produced_by.get(name)
    if pi is None or depth == 0:
        return ("leaf", name)
    n = sd.ops[pi]
    try:
        attrs = repr(sorted(n.attrs.items()))
    except Exception:
        attrs = repr(n.attrs)
    return (n.op_name, n.outputs.index(name), attrs,
            tuple(_struct_key(sd, maps, i, depth - 1) for i in n.inputs))


def fuse_parallel_matmuls(sd: SameDiff) -> int:
    """Merge sibling matmuls that contract the SAME activation against
    different 2-D parameter matrices into ONE wide matmul
    (``concat(w_1..w_n, axis=1)`` then split) — the imported-graph
    analogue of the zoo transformer's fused Wqkv projection.

    TF freezes BERT's q/k/v as three separate [d, d] Tensordots over
    one hidden state; one [d, 3d] matmul is one larger GEMM and saves
    two activation reads.  Numerics are EXACT
    (same contractions, concat/split only); parameters stay separate
    VARIABLEs so names, checkpoints, and export are unchanged —
    gradients flow back through the concat.  Returns groups fused."""
    maps = _Maps(sd)
    groups: Dict[object, List[Tuple[int, str]]] = {}
    for i, n in enumerate(sd.ops):
        if n.op_name != "matmul" or len(n.outputs) != 1:
            continue
        if n.attrs.get("transpose_a") or n.attrs.get("transpose_b"):
            continue
        wname = _resolve_param_leaf(sd, maps, n.inputs[1])
        if wname is None:
            continue
        wv = sd.values.get(wname)
        if wv is None or np.asarray(wv).ndim != 2:
            continue
        key = (_struct_key(sd, maps, n.inputs[0]),
               np.asarray(wv).shape[0])
        groups.setdefault(key, []).append((i, wname))

    fused = 0
    replaced: Dict[int, OpNode] = {}   # first-member idx -> fused nodes
    dropped = set()
    for key, members in groups.items():
        if len(members) < 2:
            continue
        idxs = [i for i, _ in members]
        nodes = [sd.ops[i] for i in idxs]
        weights = [w for _, w in members]
        if len(set(weights)) != len(weights):
            continue
        sizes = [int(np.asarray(sd.values[w]).shape[1]) for w in weights]
        out0 = nodes[0].outputs[0]
        wcat = sd._unique(out0 + "/qkv_w")
        mm = sd._unique(out0 + "/qkv_mm")
        cat_node = OpNode("concat", weights, [wcat], {"axis": 1})
        mm_node = OpNode("matmul", [nodes[0].inputs[0], wcat], [mm], {})
        split_node = OpNode("split", [mm],
                            [n.outputs[0] for n in nodes],
                            {"num_split": sizes, "axis": -1})
        for name in (wcat, mm):
            sd._register(name, "ARRAY")
        replaced[idxs[0]] = [cat_node, mm_node, split_node]
        dropped.update(idxs)
        fused += 1
    if not fused:
        return 0
    new_ops: List[OpNode] = []
    for i, n in enumerate(sd.ops):
        if i in replaced:
            new_ops.extend(replaced[i])
        elif i not in dropped:
            new_ops.append(n)
    sd.ops = new_ops
    sd._fn_cache.clear()
    log.info("fuse_parallel_matmuls: %d sibling-matmul groups fused",
             fused)
    return fused


def _producer(sd: SameDiff, maps: _Maps, name: str):
    pi = maps.produced_by.get(name)
    return (pi, sd.ops[pi]) if pi is not None else (None, None)


def _resolve_param_leaf(sd: SameDiff, maps: _Maps, name: str,
                        depth: int = 4) -> Optional[str]:
    """Follow identity chains to a VARIABLE/CONSTANT, else None."""
    for _ in range(depth):
        var = sd.vars.get(name)
        if var is not None and var.var_type in ("VARIABLE", "CONSTANT"):
            return name
        pi = maps.produced_by.get(name)
        if pi is None or sd.ops[pi].op_name != "identity":
            return None
        name = sd.ops[pi].inputs[0]
    return None


def _drop_is_safe(sd: SameDiff, maps: _Maps, drop: set,
                  keep_out: str) -> bool:
    """Every output of a dropped node (except keep_out) must be
    consumed only inside the dropped set and must not be a graph
    output / loss / designated output."""
    outs = set(sd.outputs or ())
    for i in drop:
        for o in sd.ops[i].outputs:
            if o == keep_out:
                continue
            if o in maps.graph_outputs or o in sd.loss_variables \
                    or o in outs:
                return False
            if any(c not in drop for c in maps.consumers.get(o, [])):
                return False
    return True


def _single_axis_const(sd: SameDiff, name: str) -> Optional[int]:
    """The reduction axis when ``name`` is a single-axis constant
    (TF canonicalizes axis=-1 to the positive rank-relative index)."""
    var = sd.vars.get(name)
    if var is None or var.var_type != "CONSTANT":
        return None
    a = np.asarray(sd.values[name]).reshape(-1)
    return int(a[0]) if a.size == 1 else None


def _match_layer_norm(sd: SameDiff, maps: _Maps, ai: int):
    """Match TF/Keras LayerNormalization's frozen decomposition rooted
    at op ``ai`` (the final add):

        m    = rsqrt(var + eps) * gamma
        out  = x*m + (beta - mean*m)
        var  = mean((x - stop_grad(mean))^2, -1)   # tf.nn.moments

    Returns (x, gamma, beta, eps, drop_idx_set) or None."""
    node = sd.ops[ai]
    if node.op_name != "add":
        return None
    for p, q in ((node.inputs[0], node.inputs[1]),
                 (node.inputs[1], node.inputs[0])):
        mi1, mul1 = _producer(sd, maps, p)
        si, subn = _producer(sd, maps, q)
        if mul1 is None or subn is None or mul1.op_name != "mul" \
                or subn.op_name != "sub":
            continue
        beta = _resolve_param_leaf(sd, maps, subn.inputs[0])
        mi2, mul2 = _producer(sd, maps, subn.inputs[1])
        if beta is None or mul2 is None or mul2.op_name != "mul":
            continue
        for x, m in ((mul1.inputs[0], mul1.inputs[1]),
                     (mul1.inputs[1], mul1.inputs[0])):
            if m not in mul2.inputs:
                continue
            mean_out = (mul2.inputs[0] if mul2.inputs[1] == m
                        else mul2.inputs[1])
            mmi, mnode = _producer(sd, maps, m)
            if mnode is None or mnode.op_name != "mul":
                continue
            for rs_out, gamma_ref in ((mnode.inputs[0], mnode.inputs[1]),
                                      (mnode.inputs[1],
                                       mnode.inputs[0])):
                gamma = _resolve_param_leaf(sd, maps, gamma_ref)
                ri, rs = _producer(sd, maps, rs_out)
                if gamma is None or rs is None or rs.op_name != "rsqrt":
                    continue
                ei, adde = _producer(sd, maps, rs.inputs[0])
                if adde is None or adde.op_name != "add":
                    continue
                eps = _scalar_const(sd, adde.inputs[1])
                var_out = adde.inputs[0]
                if eps is None:
                    eps = _scalar_const(sd, adde.inputs[0])
                    var_out = adde.inputs[1]
                if eps is None:
                    continue
                vi, var = _producer(sd, maps, var_out)
                if var is None or var.op_name != "reduce_mean" \
                        or not var.attrs.get("keep_dims"):
                    continue
                axis = _single_axis_const(sd, var.inputs[1])
                if axis is None:
                    continue
                qi, sqd = _producer(sd, maps, var.inputs[0])
                if sqd is None or sqd.op_name != "squared_difference" \
                        or sqd.inputs[0] != x:
                    continue
                sg_out = sqd.inputs[1]
                gi, sg = _producer(sd, maps, sg_out)
                drop = {ai, mi1, si, mi2, mmi, ri, ei, vi, qi}
                if sg is not None and sg.op_name == "stop_gradient":
                    mean_ref = sg.inputs[0]
                    drop.add(gi)
                else:
                    mean_ref = sg_out
                if mean_ref != mean_out:
                    continue
                ni, mean = _producer(sd, maps, mean_out)
                if mean is None or mean.op_name != "reduce_mean" \
                        or not mean.attrs.get("keep_dims") \
                        or mean.inputs[0] != x \
                        or _single_axis_const(sd, mean.inputs[1]) != axis:
                    continue
                drop.add(ni)
                if not _drop_is_safe(sd, maps, drop, node.outputs[0]):
                    continue
                return x, gamma, beta, float(eps), axis, drop
    return None


def fuse_layer_norm(sd: SameDiff) -> int:
    """Collapse frozen-TF LayerNormalization subgraphs (9-11 ops, two
    separate reductions, five full activation round-trips) into the
    single registry ``layer_norm`` op — fewer passes over x.  Gradients
    are identical: tf.nn.moments' stop_gradient(mean) term contributes
    exactly zero (d var/d mean = -2*E[x-mean] = 0).  Returns sites
    fused."""
    total = 0
    while True:          # one scan per ROUND: collect disjoint matches
        maps = _Maps(sd)
        matches, taken = [], set()
        for ai in range(len(sd.ops)):
            m = _match_layer_norm(sd, maps, ai)
            if m is None or (m[-1] & taken):
                continue
            matches.append((ai, m))
            taken |= m[-1]
        if not matches:
            return total
        replace = {ai: OpNode("layer_norm", [x, gamma, beta],
                              [sd.ops[ai].outputs[0]],
                              {"axis": axis, "eps": eps})
                   for ai, (x, gamma, beta, eps, axis, _) in matches}
        keep = {sd.ops[ai].outputs[0] for ai in replace}
        new_ops = []
        for i, n in enumerate(sd.ops):
            if i in replace:
                new_ops.append(replace[i])
            elif i not in taken:
                new_ops.append(n)
        for i in taken:
            for o in sd.ops[i].outputs:
                if o not in keep:
                    sd.vars.pop(o, None)
        sd.ops = new_ops
        sd._fn_cache.clear()
        total += len(matches)


def _match_gelu(sd: SameDiff, maps: _Maps, ai: int):
    """Match Keras's exact-gelu decomposition rooted at ``ai``:
    ``(0.5*h) * erfc(-h/sqrt(2))``.  Returns (h, drop_set) or None."""
    node = sd.ops[ai]
    if node.op_name != "mul":
        return None
    for p, q in ((node.inputs[0], node.inputs[1]),
                 (node.inputs[1], node.inputs[0])):
        hi, half_mul = _producer(sd, maps, p)
        ci, erfc = _producer(sd, maps, q)
        if half_mul is None or erfc is None \
                or half_mul.op_name != "mul" or erfc.op_name != "erfc":
            continue
        c_half = _scalar_const(sd, half_mul.inputs[0])
        h = half_mul.inputs[1]
        if c_half is None:
            c_half = _scalar_const(sd, half_mul.inputs[1])
            h = half_mul.inputs[0]
        if c_half is None or abs(c_half - 0.5) > 1e-6:
            continue
        ii, inner = _producer(sd, maps, erfc.inputs[0])
        if inner is None or inner.op_name != "mul":
            continue
        c_rs2 = _scalar_const(sd, inner.inputs[0])
        neg_out = inner.inputs[1]
        if c_rs2 is None:
            c_rs2 = _scalar_const(sd, inner.inputs[1])
            neg_out = inner.inputs[0]
        if c_rs2 is None or abs(c_rs2 - 0.7071067811865476) > 1e-6:
            continue
        ngi, neg = _producer(sd, maps, neg_out)
        if neg is None or neg.op_name != "neg" or neg.inputs[0] != h:
            continue
        drop = {ai, hi, ci, ii, ngi}
        if not _drop_is_safe(sd, maps, drop, node.outputs[0]):
            continue
        return h, drop
    return None


def fuse_gelu(sd: SameDiff) -> int:
    """Collapse the frozen exact-gelu chain (mul/neg/mul/erfc/mul —
    four activation round-trips on the [b, t, 4d] FFN tensor) into the
    registry ``gelu`` op (exact gelu, approximate=False; erfc(-z) ==
    1+erf(z), same function).  Returns sites fused."""
    total = 0
    while True:          # one scan per ROUND: collect disjoint matches
        maps = _Maps(sd)
        matches, taken = [], set()
        for ai in range(len(sd.ops)):
            m = _match_gelu(sd, maps, ai)
            if m is None or (m[1] & taken):
                continue
            matches.append((ai, m))
            taken |= m[1]
        if not matches:
            return total
        replace = {ai: OpNode("gelu", [h], [sd.ops[ai].outputs[0]],
                              {"approximate": False})
                   for ai, (h, _) in matches}
        keep = {sd.ops[ai].outputs[0] for ai in replace}
        new_ops = []
        for i, n in enumerate(sd.ops):
            if i in replace:
                new_ops.append(replace[i])
            elif i not in taken:
                new_ops.append(n)
        for i in taken:
            for o in sd.ops[i].outputs:
                if o not in keep:
                    sd.vars.pop(o, None)
        sd.ops = new_ops
        sd._fn_cache.clear()
        total += len(matches)


def rewrite_check_enabled() -> bool:
    """``DL4J_TPU_REWRITE_CHECK=1`` (the reference's switch): every
    rewrite pass in ``optimize_for_tpu`` asserts it preserved the graph's
    inferred output shapes (and dtypes, when not deliberately re-typing)
    via a run on ``meta`` tensors — shapes only, no device memory.
    Catches the ``fold_flatten_reshapes``-style axis bug class AT
    REWRITE TIME instead of at numerics-parity time.  A debug mode:
    one probe run per mutating pass (plus one up front — each pass's
    post-signature is reused as the next pass's baseline)."""
    import os
    return os.environ.get("DL4J_TPU_REWRITE_CHECK", "") in ("1", "true")


PROBE_DIM = 2   # the size an unknown placeholder dim takes in the probe


def _terminal_outputs(sd: SameDiff) -> List[str]:
    if sd.outputs:
        return list(sd.outputs)
    consumed = {i for n in sd.ops for i in n.inputs}
    outs = [o for n in sd.ops for o in n.outputs if o not in consumed]
    return outs + [l for l in sd.loss_variables if l not in outs]


def infer_shapes(sd: SameDiff, probe_dim: int = PROBE_DIM) -> Dict:
    """``{terminal_output: (shape, dtype)}`` from one run of the graph
    on ``meta`` tensors, unknown placeholder dims set to ``probe_dim``
    (the reference's ``symbolic=False`` probe; the port has no symbolic
    shapes).  Raises whatever the run raises."""
    import torch
    from deeplearning4j_torch.runtime.dtype import canonical_dtype
    outs = _terminal_outputs(sd)
    if not outs:
        return {}
    meta = torch.device("meta")
    feeds = {}
    for v in sd.vars.values():
        if v.var_type == "PLACEHOLDER":
            shape = tuple((probe_dim if (d is None or int(d) < 0)
                           else int(d)) for d in (v.shape or ()))
            feeds[v.name] = torch.empty(shape, device=meta,
                                        dtype=canonical_dtype(v.dtype))
    params = {k: torch.empty(np.shape(val), device=meta,
                             dtype=torch.from_numpy(
                                 np.zeros(0, np.asarray(val).dtype)).dtype)
              for k, val in sd._param_values().items()}
    saved = sd.device
    sd.device = meta
    try:
        with torch.no_grad():
            env = sd._run_graph(params, feeds, sd._needed_for(outs))
    finally:
        sd.device = saved
    res = {}
    for o in outs:
        r = env[o]
        if isinstance(r, torch.Tensor):
            dt = str(r.dtype).replace("torch.", "")
        else:
            dt = str(np.asarray(r).dtype)
        res[o] = (tuple(int(d) for d in np.shape(r)), dt)
    return res


def _shape_signature(sd: SameDiff):
    """``(symbolic_sig, probe_sig)`` as the reference returns them, or
    None when the graph cannot run on the probe (dynamic control flow,
    data-dependent shapes); parity checking is then skipped, not
    failed.  The port has only the probe, so both halves are the probe
    and the check compares like with like."""
    try:
        probe = infer_shapes(sd)
    except Exception:
        return None
    return (probe, probe)


def _is_symbolic(sig) -> bool:
    return any(isinstance(d, str) for shape, _ in sig.values()
               for d in shape)


def _comparable(before, after):
    """Pick the (before, after) signature pair in matching modes."""
    b_sym, b_probe = before
    a_sym, a_probe = after
    if _is_symbolic(b_sym) == _is_symbolic(a_sym):
        return b_sym, a_sym
    return b_probe, a_probe


def _run_rewrite_pass(sd: SameDiff, tag: str, fn,
                      check_dtypes: bool = True,
                      carry: Optional[dict] = None) -> int:
    """Run one rewrite pass, parity-checked when the debug flag is on.
    ``carry`` (a dict, shared across a pipeline) caches the signature
    between passes so each graph state is abstractly traced once."""
    if not rewrite_check_enabled():
        return fn()
    before = carry.get("sig") if carry else None
    if before is None:
        before = _shape_signature(sd)
    n = fn()
    if not n or before is None:
        if carry is not None:
            carry["sig"] = before        # graph unchanged when n == 0
        return n
    after = _shape_signature(sd)
    if carry is not None:
        carry["sig"] = after
    if after is None:
        raise AssertionError(
            f"rewrite pass '{tag}' broke the graph: it traced before "
            "the pass but shape inference now fails")
    before_sig, after_sig = _comparable(before, after)
    bad = []
    for out, (shape, dtype) in before_sig.items():
        got = after_sig.get(out)
        if got is None:
            bad.append(f"{out}: output disappeared")
        elif got[0] != shape:
            bad.append(f"{out}: shape {shape} -> {got[0]}")
        elif check_dtypes and got[1] != dtype:
            bad.append(f"{out}: dtype {dtype} -> {got[1]}")
    if bad:
        raise AssertionError(
            f"rewrite pass '{tag}' changed inferred outputs "
            f"({'; '.join(bad)}) — the rewrite is not "
            "semantics-preserving")
    return n


def optimize_for_tpu(sd: SameDiff,
                     compute_dtype: Optional[str] = None,
                     fold_causal_masks: bool = True) -> Dict[str, int]:
    """Run the full imported-graph canonicalization pipeline — the
    platform-helper seam in one call.  Returns per-pass fusion counts.

    With ``DL4J_TPU_REWRITE_CHECK=1`` every pass asserts shape-probe
    parity on the graph's outputs (see :func:`rewrite_check_enabled`);
    the attention pass skips the dtype half of the check when
    ``compute_dtype`` deliberately re-types the fused node.

    ``fold_causal_masks=False`` keeps constant-triangular attention
    biases as explicit ``[t, t]`` bias operands instead of folding them
    into the kernel's ``causal=True`` path — the opt-out for callers
    FINE-TUNING an importer-promoted trainable mask (the fold freezes
    it at exact-causal and it stops receiving gradients); the default
    folds, which is what every frozen-import serving path wants."""
    carry: Dict[str, object] = {}
    return {
        "parallel_matmuls": _run_rewrite_pass(
            sd, "parallel_matmuls", lambda: fuse_parallel_matmuls(sd),
            carry=carry),
        "layer_norm": _run_rewrite_pass(
            sd, "layer_norm", lambda: fuse_layer_norm(sd), carry=carry),
        "gelu": _run_rewrite_pass(sd, "gelu", lambda: fuse_gelu(sd),
                                  carry=carry),
        "attention": _run_rewrite_pass(
            sd, "attention",
            lambda: fuse_attention(sd, compute_dtype=compute_dtype,
                                   fold_causal_masks=fold_causal_masks),
            check_dtypes=compute_dtype is None, carry=carry),
        # last: operates on the matmuls the passes above left unfused
        "flatten_reshapes": _run_rewrite_pass(
            sd, "flatten_reshapes", lambda: fold_flatten_reshapes(sd),
            carry=carry),
    }


# Ops that treat the last axis identically at any rank — a fold that
# changes a tensor from [b*t, n] to [b, t, n] commutes with these.
# "split" qualifies ONLY when its axis is spelled -1: a positional axis
# (e.g. 1, resolved against the pre-fold rank-2 matmul output) would
# slice the t dimension of the folded rank-3 tensor — silently wrong
# numerics, checked per-node in the consumer walk (ADVICE r5).
_RANK_POLY = frozenset(("bias_add", "add", "identity", "mul", "split",
                        "gelu", "tanh", "relu"))


def fold_flatten_reshapes(sd: SameDiff) -> int:
    """Drop TF Tensordot's 2D-ification reshape in front of matmuls.

    tf.Tensordot (every Keras Dense on rank-3 input — the frozen BERT
    emits one per FF/projection layer) lowers ``x @ W`` as
    ``transpose -> reshape(x, [prod(lead), k]) -> MatMul -> reshape
    back``.  ``torch.matmul`` contracts rank-3 @ rank-2 natively, so the
    sandwich is pure overhead (two reshapes and a transpose per dense
    layer).

    Only the INPUT-side reshape is dropped, which is semantics-
    preserving without any shape proof: (a) the reshape must flatten to
    a 2-element target (const or Tensordot's pack) — the folded matmul
    carries ``expect_k`` (W's contraction size) and re-applies the
    flatten at run time unless the contraction axis is already
    innermost, so the fold is exactly the original computation in
    every case; and (b) every consumer path from the matmul reaches a
    computed reshape through rank-polymorphic ops only (reshape(y, s)
    gives identical results for any rank of y — same elements, same
    row-major order, same target — so the downstream reshape
    re-normalizes the shape and itself folds to a no-op when the target
    equals the new natural shape).  Returns the number of folds."""
    maps = _Maps(sd)
    # the REAL graph outputs, captured before folding orphans anything
    # (post-fold, an orphaned reshape is indistinguishable from a
    # terminal output by the no-consumers heuristic)
    protected = (set(sd.outputs or ()) | set(sd.loss_variables)
                 | set(maps.graph_outputs))
    folds = 0
    for n in sd.ops:
        if n.op_name != "matmul" or n.attrs.get("transpose_a"):
            continue
        pi, r1 = _producer(sd, maps, n.inputs[0])
        if r1 is None or r1.op_name != "reshape" or \
                not _single_consumer(maps, sd, r1.outputs[0]):
            continue
        # contraction size from the parameter operand — possibly a
        # column-concat of params (fuse_parallel_matmuls' fused qkv)
        k = None
        wname = _resolve_param_leaf(sd, maps, n.inputs[1])
        if wname is not None:
            w = np.asarray(sd.values[wname])
            if w.ndim == 2:
                k = int(w.shape[1] if n.attrs.get("transpose_b")
                        else w.shape[0])
        else:
            _, wc = _producer(sd, maps, n.inputs[1])
            if wc is not None and wc.op_name == "concat" \
                    and not n.attrs.get("transpose_b"):
                # axis rides as an attr on our fused concat, as the
                # trailing input on an imported TF ConcatV2
                if "axis" in wc.attrs:
                    axis, wins = int(wc.attrs["axis"]), wc.inputs
                else:
                    axis, wins = _scalar_const(sd, wc.inputs[-1]), \
                        wc.inputs[:-1]
                leaves = [_resolve_param_leaf(sd, maps, p)
                          for p in wins]
                if axis in (1, -1) and all(l is not None for l in leaves):
                    shapes = {np.asarray(sd.values[l]).shape
                              for l in leaves}
                    if all(len(s) == 2 for s in shapes) and \
                            len({s[0] for s in shapes}) == 1:
                        k = int(next(iter(shapes))[0])
        if k is None:
            continue
        # the reshape must flatten to a 2-element target: a constant
        # [m|-1, k] vector, or Tensordot's pack(Prod, Prod_1) (both
        # dims computed dynamically — trace-time expect_k handles it)
        sname = r1.inputs[1]
        two_elem = False
        sval = sd.values.get(sname)
        if sval is not None:
            two_elem = np.asarray(sval).reshape(-1).size == 2
        else:
            _, sn = _producer(sd, maps, sname)
            two_elem = (sn is not None and sn.op_name == "pack"
                        and len(sn.inputs) == 2)
        if not two_elem:
            continue
        # every consumer path must reach a reshape via rank-poly ops
        ok, frontier, hops = True, [n.outputs[0]], 0
        while frontier and hops < 8:
            hops += 1
            nxt = []
            for o in frontier:
                cons = maps.consumers.get(o, [])
                if not cons or o in maps.graph_outputs \
                        or o in (sd.outputs or ()):
                    ok = False
                    break
                for ci in cons:
                    cn = sd.ops[ci]
                    if cn.op_name == "reshape":
                        continue        # re-normalizes: path closed
                    if cn.op_name not in _RANK_POLY:
                        ok = False
                        break
                    if cn.op_name == "split" and \
                            int(cn.attrs.get("axis", 0)) != -1:
                        # only the rank-stable "last axis" spelling
                        # commutes with the rank change (see _RANK_POLY)
                        ok = False
                        break
                    nxt.extend(cn.outputs)
                if not ok:
                    break
            if not ok:
                break
            frontier = nxt
        if not ok or frontier:
            continue
        # fold: matmul consumes r1's input directly; trace-time guard
        n.inputs[0] = r1.inputs[0]
        n.attrs["expect_k"] = k
        folds += 1
        maps = _Maps(sd)                # consumer map changed
    if folds:
        # orphaned reshapes (and their shape-math chains) are pruned
        # by the needed-set at trace time; drop them from the op list
        # too (to fixpoint) so op counts reflect the graph that runs
        while True:
            maps = _Maps(sd)
            live = []
            for i, n in enumerate(sd.ops):
                if any(maps.consumers.get(o) or o in protected
                       for o in n.outputs):
                    live.append(i)
            if len(live) == len(sd.ops):
                break
            keep = set(live)
            for i, n in enumerate(sd.ops):
                if i not in keep:
                    for o in n.outputs:
                        sd.vars.pop(o, None)
            sd.ops = [n for i, n in enumerate(sd.ops) if i in keep]
        sd._fn_cache.clear()
    return folds


def _looks_attention_shaped(sd: SameDiff) -> bool:
    """Cheap structural probe: any softmax with a matmul above its
    input AND a matmul within a few hops below its output — i.e. a
    graph a user would EXPECT fuse_attention to hit."""
    maps = _Maps(sd)
    for node in sd.ops:
        if node.op_name != "softmax":
            continue
        seen, stack, has_mm_above = set(), [node.inputs[0]], False
        for _ in range(32):
            if not stack:
                break
            pi = maps.produced_by.get(stack.pop())
            if pi is None or pi in seen:
                continue
            seen.add(pi)
            if sd.ops[pi].op_name == "matmul":
                has_mm_above = True
                break
            stack.extend(sd.ops[pi].inputs[:2])
        if not has_mm_above:
            continue
        cur = node.outputs[0]
        for _ in range(4):
            cons = maps.consumers.get(cur, [])
            if not cons:
                break
            n = sd.ops[cons[0]]
            if n.op_name == "matmul":
                return True
            cur = n.outputs[0]
    return False


def _const_eval(sd: SameDiff, maps: _Maps, name: str):
    """Evaluate ``name`` at its CURRENT values when its subgraph has no
    placeholders.  VARIABLE leaves are allowed — the frozen-graph
    importer promotes every large float const (including attention
    masks) to a trainable VARIABLE, so a pure-const policy would never
    fire on imported graphs; the caller decides whether folding a
    variable-valued operand away is acceptable.  None when data-
    dependent or evaluation fails."""
    stack, seen = [name], set()
    while stack:
        nm = stack.pop()
        if nm in seen:
            continue
        seen.add(nm)
        v = sd.vars.get(nm)
        if v is not None and v.var_type == "PLACEHOLDER":
            return None
        pi = maps.produced_by.get(nm)
        if pi is not None:
            stack.extend(sd.ops[pi].inputs)
    try:
        if name in sd.values:
            return np.asarray(sd.values[name])
        out = sd.output({}, [name])[name]
        return out.detach().to("cpu").numpy() if hasattr(out, "detach") \
            else np.asarray(out)
    except Exception:
        return None


def _bias_is_causal_mask(sd: SameDiff, maps: _Maps, bias_name: str
                         ) -> bool:
    """True when the matched additive bias is a constant [t, t] (or
    leading-1-padded) lower-triangular causal mask: ~0 on and below the
    diagonal, <= -1e8 above it — the standard imported-GPT masking
    idiom (tril constant, or band_part/ones-minus-tril arithmetic
    folded at import).  Such a mask is EXACTLY ``causal=True`` on the
    fused node, which reaches the flash kernel's causal path instead of
    being rejected as a query-dependent bias."""
    val = _const_eval(sd, maps, bias_name)
    if val is None:
        return False
    a = np.asarray(val, np.float64)
    while a.ndim > 2 and a.shape[0] == 1:
        a = a[0]
    if a.ndim != 2 or a.shape[0] != a.shape[1] or a.shape[0] < 2:
        return False
    tril = np.tril(np.ones(a.shape, bool))
    return bool(np.all(np.abs(a[tril]) < 1e-6)
                and np.all(a[~tril] <= -1e8))


def fuse_attention(sd: SameDiff, compute_dtype: Optional[str] = None,
                   fold_causal_masks: bool = True) -> int:
    """Rewrite attention subgraphs into ``fused_attention`` nodes.

    Every intermediate must have exactly one consumer (so the rewrite
    cannot orphan a fetched tensor); the q/k/v/bias inputs themselves
    may fan out freely (BERT shares the mask bias across layers).

    ``compute_dtype='bfloat16'`` makes the fused node run its attention
    in bf16 (the training configuration); None preserves
    import numerics exactly (parity tests).
    ``fold_causal_masks=False`` keeps a constant-triangular bias as an
    explicit operand (the ``[t, t]``-memory path) so an importer-
    promoted trainable mask keeps receiving gradients — see
    :func:`optimize_for_tpu`.  Returns the number of attention sites
    fused."""
    total = 0
    while True:                      # re-derive maps after each fusion
        maps = _Maps(sd)
        match = None
        for si, node in enumerate(sd.ops):
            if node.op_name != "softmax" or \
                    int(node.attrs.get("axis", -1)) != -1:
                continue
            pv = _match_pv(sd, maps, node.outputs[0])
            if pv is None:
                continue
            mi, passthrough = pv
            scores = _match_scores(sd, maps, node.inputs[0], True)
            if scores is None:
                continue
            q, k, scale, bias, chain = scores
            match = (si, mi, passthrough, q, k, sd.ops[mi].inputs[1],
                     bias, scale, chain)
            break
        if match is None:
            if total == 0 and _looks_attention_shaped(sd):
                log.warning(
                    "fuse_attention: 0 sites fused but the graph looks "
                    "attention-shaped (matmul->softmax->matmul present)"
                    " — a non-matching variant (scale below bias, "
                    "multi-consumer probs, transpose layout) keeps it "
                    "on the unfused [t, t]-memory path")
            return total
        si, mi, passthrough, q, k, v, bias, scale, chain = match
        causal = False
        bias_layout = None
        if bias is not None and _bias_is_causal_mask(sd, maps, bias):
            if fold_causal_masks:
                # constant-valued triangular mask == causal=True: drop
                # the mask operand so the flash kernel's causal path is
                # reachable (a [t, t] query-dependent bias never is)
                bv = sd.vars.get(bias)
                if bv is not None and bv.var_type == "VARIABLE":
                    # the importer promoted the mask const to a
                    # trainable VARIABLE; folding freezes it at
                    # exact-causal — say so (same honesty stance as
                    # the dropout-drop warning)
                    log.warning(
                        "fuse_attention: causal-fusing mask variable "
                        "%s — it is replaced by the kernel's causal "
                        "path and no longer receives gradient updates",
                        bias)
                causal, bias = True, None
            else:
                # opt-out (fine-tuning the mask): keep the operand,
                # but a square [tq, tk] bias must be declared — the
                # lowering's 2-D convention is a [b, tk] key-position
                # padding mask, and b == tq makes the two ambiguous
                bias_layout = "qk"
        # Fusion-path honesty: a dropout node in
        # the probs chain is deleted by this rewrite.  The registry's
        # `dropout` op is ALREADY inert (imported graphs freeze
        # keep_prob=1), so numerics do not change — but if the node
        # declares a nonzero rate, the original model's TRAINING config
        # wanted attention dropout, and a fine-tune through either path
        # runs without it.  Say so instead of staying silent.
        for pt in passthrough:
            n = sd.ops[pt]
            rate = float(n.attrs.get("rate", 0.0) or 0.0)
            if n.op_name == "dropout" and rate > 0.0:
                log.warning(
                    "fuse_attention: dropping attention-dropout node "
                    "%s (rate=%.3g) — fine-tuning runs WITHOUT "
                    "attention dropout (the reference model trained "
                    "with it)", n.outputs[0], rate)
        drop = set(chain) | set(passthrough) | {si, mi}
        inputs = [q, k, v] + ([bias] if bias is not None else [])
        attrs = {"causal": causal,
                 "scale": 1.0 if scale is None else float(scale),
                 "compute_dtype": compute_dtype}
        if bias_layout is not None:
            attrs["bias_layout"] = bias_layout
        fused = OpNode("fused_attention", inputs,
                       [sd.ops[mi].outputs[0]], attrs)
        new_ops: List[OpNode] = []
        for i, n in enumerate(sd.ops):
            if i == mi:
                new_ops.append(fused)
            elif i not in drop:
                new_ops.append(n)
        keep_out = fused.outputs[0]
        for i in drop:                # orphaned intermediate ARRAY vars
            for o in sd.ops[i].outputs:
                if o != keep_out:
                    sd.vars.pop(o, None)
        sd.ops = new_ops
        sd._fn_cache.clear()
        total += 1
