"""MF-MAC linear layers with their backward (port of ``repro/core/mfmac.py``:
``mf_linear``, ``mf_expert_linear``, ``mf_act_dot`` and ``mf_conv2d``;
Algorithm 1).

Forward (lines 4-8):
    Wq = ALS-PoTQ(W - mean(W))            # WBC then quantize
    Aq = ALS-PoTQ(clip(A, gamma*max|A|))  # PRC then quantize
    out = MF_MAC(Aq, Wq)                  # kernels/ops.pot_value_matmul (K1)

Backward (lines 13-15): the incoming gradient G is ALS-PoTQ quantized
once (``bits_g_last`` into the LM head), in the kernels' scaled domain,
and reused:
    dA = MF_MAC(Gq, Wq^T), then PRC's clip mask and dgamma   (K2)
    dW = MF_MAC(Aq^T, Gq), the raw MAC output (STE)          (K3)
through ``kernels/ops.potq_grad_matmuls``.

The MACs run over the *dequantized* PoT values (exact in bf16), with the
numeric spec of ``kernels/ref.py``.  ``mf_linear`` is a
``torch.autograd.Function``: the clamp, the scales and the rounding all
happen inside its forward, so autograd never sees through them — a's
gradient is the masked dA, gamma's the kernel's dgamma and w's the raw dW,
as in the reference's ``custom_vjp``.  dW keeps float32 whatever w's dtype
is, so the training step differentiates float32 weights (the shadow of
``train/step.py`` holds exact PoT values in float32).

``mf_expert_linear`` is the MoE experts' a[E, T, K] @ w[E, K, N]: each
expert is its own "layer" (its own W scale and WBC mean, its own A scale
and PRC threshold), the forward is ONE launch of K1's expert-batched form
(``ops.pot_value_bmm``) and the backward runs K2/K3 once per expert
(``ops.potq_expert_grad_matmuls``), as the reference's vmap does.

``mf_act_dot`` is the attention's activation-by-activation product
x[..., M, K] @ y[..., K, N] (QK^T and PV).  Under
``policy.quantize_attention`` both operands are PoT-quantized without a
PRC clip and the product runs over their exact values in float32 (no
kernel: the reference's is a plain dot outside any Pallas kernel);
otherwise it is today's plain product, bit for bit.  On a plan its
scales are global too: over the model ranks where the heads are split,
over the data ranks where a per-tensor group's rows are (G's over both).

``mf_conv2d`` is a convolution as im2col (pure data movement, the
reference's ``conv_general_dilated_patches`` element for element) followed
by ``mf_linear``: K1 forward, K2 and K3 backward at conv shapes.

On a sharded plan (``parallel/actshard.py``) the quantizers take global
maxima wherever their input is split: the per-tensor activation amax and
PRC threshold, and the backward's max|G| (the G scale of
``kernels/ops.py``), over the data axis when the batch rows are split
(data-parallel training), and so are an expert linear's per-expert
activation amax, PRC threshold and max|G| (an expert's rows are the
dispatch groups of every data rank); the activation amax (per tensor or per sample)
over the model axis when the contraction is split (``row_group``: a
row-parallel linear, whose K1 fold continues across the ranks,
``parallel/collectives.ordered_fold``).  Max is exact, so each quantized
value is one rank's, bit for bit.  Without a plan nothing changes.

The backward on a model axis (tensor-parallel training; the model ranks
hold the same replicated activations, and each its shard of a linear's
weight, quantized whole by the training step's shadow):

* a column-parallel linear (``col_group``: its N split over the ranks,
  its input whole on each): max|G| is global over the data and model
  groups (a rank's G holds its columns only); dA = Gq·Wq^T contracts
  over the split N, so K2's fold is chained across the ranks in rank
  order (``collectives.chained``, K2's ``start``): the ranks before the
  last pass the raw running sum on, the last dequantizes, runs the PRC
  epilogue and hands dA and the dgamma rows to every rank.  That needs
  whole 128-chunks a rank; a narrower shard (a smoke width) gathers G and
  Wq and computes dA whole on every rank, as the forward's 'gather' mode
  does a row-parallel product, and so does a linear whose columns are an
  index set of pieces (``col_cuts``: an ssm's in_proj, its heads' z, x
  and dt columns and the B and C columns every rank holds), G and Wq
  placed at their offsets in the whole N.  dW = Aq^T·Gq is local (its
  contraction over M is whole on each rank): this rank's columns, bit
  for bit;
* a row-parallel linear (``row_group``, :func:`_row_parallel`): G is whole
  on every rank, so dA (this rank's K columns) and dW (its K rows) are
  local; max|G| is global over the data group only; the PRC threshold's
  amax is global over the model group too, as in the forward; the dgamma
  rows' left fold over K chunks is chained across the ranks (K2's fold
  kernel's ``rows_start``).

* an expert linear (``mf_expert_linear``): under EP (``expert_group``)
  a rank's experts are whole, so their scales and launches are local and
  only the shared gamma's per-expert dgammas are all-gathered, in expert
  order, and folded on every rank; under TP (``col_group``: every
  expert's N split) each expert is a column-parallel linear, its max|G|
  global over the model ranks and its dA chained across them, all the
  experts' running sums in one chain (:func:`_expert_column_grads`).

Each chain reproduces one rank's adds in one rank's order, so dA, dW and
dgamma are one rank's bit for bit.

The low-bit self-draft re-quantizes served weights at use; on a model
axis a shard is rounded with its whole matrix's WBC mean and scale
(:func:`whole_stats`), which a row-parallel product also accepts.
Unquantized (the FP32 baseline) a row-parallel product adds the ranks'
partial products in rank order: one rank's within float32 rounding.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import potq
from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import ops
from repro_torch.kernels.ref import CANONICAL_BK, halves_fold
from repro_torch.parallel import actshard, collectives
from repro_torch.parallel.planner import ShardingPlan

_BF16 = torch.bfloat16


def _pot_matmul(x: torch.Tensor, y: torch.Tensor, policy: QuantPolicy) -> torch.Tensor:
    """(M,K)@(K,N) over already-quantized (PoT-valued) operands."""
    return ops.pot_value_matmul(x, y, bits_a=policy.bits_a, bits_w=policy.bits_w)


def _pot_bmm(x: torch.Tensor, y: torch.Tensor, policy: QuantPolicy) -> torch.Tensor:
    """(E,M,K)@(E,K,N) over already-quantized operands, one K1 launch."""
    return ops.pot_value_bmm(x, y, bits_a=policy.bits_a, bits_w=policy.bits_w)


#: elements of one block of rows in :func:`_quantize_w`'s rounding: its
#: full-size float32 temporaries (several per element) stay this small
W_BLOCK_ELEMS = 1 << 25


class WholeStats(dict):
    """Whole-matrix statistics of the weights a model rank holds shards
    of: ``{weight_key(shard view): (mean, beta)}`` (:func:`whole_stats`),
    and the address spans of the leaves whose trailing matrices are split
    (:meth:`add_leaf`), where a view without an entry is refused."""

    def __init__(self):
        super().__init__()
        self.spans = []

    def add_leaf(self, x: torch.Tensor) -> None:
        start = x.data_ptr()
        self.spans.append((start, start + x.numel() * x.element_size()))

    def covers(self, w: torch.Tensor) -> bool:
        return any(lo <= w.data_ptr() < hi for lo, hi in self.spans)


#: the active table (:func:`whole_stats`)
_W_STATS = WholeStats()


def weight_key(w: torch.Tensor):
    """The key of a weight view in :func:`whole_stats`' table: its
    address and shape (a stacked leaf's per-layer views differ in the
    first, a stack and its first matrix in the second)."""
    return w.data_ptr(), tuple(w.shape)


@contextlib.contextmanager
def whole_stats(table: WholeStats):
    """Quantize the weights that ``table`` lists with its statistics
    instead of their own: a shard of a matrix split over the model ranks
    rounded with the whole matrix's WBC mean and scale
    (``serve/quantized_weights.draft_stats``), so each rank rounds its
    shard as the whole matrix would be rounded.  A view of a split leaf
    that the table does not list raises: its own statistics would be a
    shard's."""
    global _W_STATS
    prev, _W_STATS = _W_STATS, table
    try:
        yield
    finally:
        _W_STATS = prev


def weight_stats(w: torch.Tensor, policy: QuantPolicy, axes=None):
    """``(mean, beta)`` that :func:`_quantize_w` takes of ``w``: its WBC
    mean (None without WBC) and its PoT scale, per ``axes`` group (one
    for the whole matrix when None)."""
    w = w.to(torch.float32)
    wbc = policy.weight_bias_correction
    if axes is not None:
        mean = w.mean(dim=tuple(axes), keepdim=True) if wbc else None
        return mean, potq.compute_beta(w if mean is None else w - mean, policy.bits_w, axes)
    # the largest |w - mean| from each block's extremes (rounding w - mean
    # is monotone in w, so this is exact)
    mean = w.mean() if wbc else None
    rows = w.reshape(-1, w.shape[-1])
    step = max(1, W_BLOCK_ELEMS // rows.shape[1])
    ext = torch.stack([torch.stack(torch.aminmax(rows[r:r + step]))
                       for r in range(0, rows.shape[0], step)])
    return mean, potq.compute_beta(ext if mean is None else ext - mean, policy.bits_w)


def _quantize_w(w: torch.Tensor, policy: QuantPolicy, axes=None) -> torch.Tensor:
    if policy.weights_prequantized:
        return w.to(_BF16)  # already exact PoT values (serving path)
    stats = _W_STATS.get(weight_key(w)) if _W_STATS.spans else None
    if stats is None and _W_STATS.covers(w):
        raise ValueError(f"a {tuple(w.shape)} view of a weight split over the model ranks "
                         "has no whole-matrix statistics (its own would be a shard's)")
    w = w.to(torch.float32)
    mean, beta = stats if stats is not None else weight_stats(w, policy, axes)
    if axes is not None:
        return potq.pot_quantize(w if mean is None else w - mean, policy.bits_w,
                                 beta).to(_BF16)
    # one scale for the whole matrix; the rounding runs a block of rows at
    # a time, so a large matrix (an LM head) never holds several float32
    # copies of itself
    rows = w.reshape(-1, w.shape[-1])
    step = max(1, W_BLOCK_ELEMS // rows.shape[1])
    starts = range(0, rows.shape[0], step)

    def rounded(r):
        blk = rows[r:r + step]
        return potq.pot_quantize(blk if mean is None else blk - mean,
                                 policy.bits_w, beta).to(_BF16)

    if len(starts) == 1:
        return rounded(0).reshape(w.shape)
    out = torch.empty(rows.shape, dtype=_BF16, device=w.device)
    for r in starts:
        out[r:r + step] = rounded(r)
    return out.reshape(w.shape)


def _sample_axes(policy: QuantPolicy, x: torch.Tensor, axes):
    """Scale-group axes for a forward activation: per-sample (all dims but
    the leading batch dim) under ``policy.per_sample_act_scales``."""
    if axes is None and policy.per_sample_act_scales and x.dim() >= 2:
        return tuple(range(1, x.dim()))
    return axes


def _global_amax(amax: torch.Tensor, rows_split: bool, row_group) -> torch.Tensor:
    """``amax`` over every rank that holds part of its group: the data
    axis where the group's batch rows are split (a per-tensor amax, an
    expert's), the model axis for a split contraction."""
    if rows_split:
        amax = collectives.all_reduce_max(amax, actshard.batch_group())
    return collectives.all_reduce_max(amax, row_group)


def _quantize_a(a: torch.Tensor, gamma: torch.Tensor, policy: QuantPolicy,
                axes=None, row_group=None, rows_split: Optional[bool] = None) -> torch.Tensor:
    """``rows_split``: the scale group's rows are split over the data
    ranks (default: a per-tensor group)."""
    axes = _sample_axes(policy, a, axes)
    a32 = a.to(torch.float32)
    # global maxima where the input is split (identities on one rank):
    # amax, the PRC threshold t and the exact amax of the clipped values,
    # min(amax, t) (a clamp to a t < 0 sets every value to t: then -t)
    amax = a32.abs().amax() if axes is None else a32.abs().amax(dim=axes, keepdim=True)
    amax = _global_amax(amax, axes is None if rows_split is None else rows_split, row_group)
    if policy.prc_enabled:
        t = amax * gamma
        a32 = torch.clamp(a32, -t, t)
        amax = torch.where(t < 0, -t, torch.minimum(amax, t))
    beta = potq.beta_of_amax(amax, policy.bits_a)
    return potq.pot_quantize(a32, policy.bits_a, beta).to(_BF16)


def _grad_scale(g2: torch.Tensor, bits_g: int, model_group=None) -> torch.Tensor:
    """beta_g of the whole batch's G: max|G| over the data ranks (and the
    model ranks, where each holds some of G's columns)."""
    gmax = collectives.all_reduce_max(g2.abs().amax(), actshard.batch_group())
    return potq.beta_of_amax(collectives.all_reduce_max(gmax, model_group), bits_g)


class _MFLinear(torch.autograd.Function):
    """a[..., K] @ w[K, N] through K1, backward through K2 and K3;
    ``col_group``: N is split over its ranks (module docstring)."""

    @staticmethod
    def forward(ctx, a, w, gamma, policy: QuantPolicy, is_last: bool, col_group=None,
                col_cuts=None):
        aq = _quantize_a(a, gamma, policy)
        wq = _quantize_w(w, policy)
        k = a.shape[-1]
        out = _pot_matmul(aq.reshape(-1, k), wq, policy)
        ctx.policy, ctx.is_last, ctx.col_group, ctx.col_cuts = policy, is_last, col_group, col_cuts
        ctx.save_for_backward(a, aq, wq, gamma)
        return out.reshape(*a.shape[:-1], w.shape[-1]).to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        a, aq, wq, gamma = ctx.saved_tensors
        policy, group = ctx.policy, ctx.col_group
        k, n = wq.shape
        g2 = g.to(torch.float32).reshape(-1, n)
        bits_g = policy.bits_for("g", ctx.is_last)
        kw = dict(bits_g=bits_g, bits_a=policy.bits_a, bits_w=policy.bits_w,
                  per_sample_act_scales=policy.per_sample_act_scales,
                  beta_g=_grad_scale(g2, bits_g, group))
        a2 = amax = None
        if policy.prc_enabled:  # a is whole on every model rank
            a2 = a.to(torch.float32).reshape(-1, k)
            amax = collectives.all_reduce_max(a2.abs().amax(), actshard.batch_group())
        if group is None:
            da, dw, dgamma = ops.potq_grad_matmuls(
                g2, aq.reshape(-1, k), wq, a=a2,
                clip_t=None if amax is None else amax * gamma, amax=amax, **kw)
        else:  # a stack of one column-parallel product
            beta_g = kw.pop("beta_g")
            da, dw, dgs = _column_grads(
                g2[None], aq.reshape(-1, k)[None], wq[None], group, betas=[beta_g],
                a=None if a2 is None else a2[None], amax=None if amax is None else amax[None],
                gamma=gamma, cuts=ctx.col_cuts, **kw)
            da, dw, dgamma = da[0], dw[0], None if dgs is None else dgs[0]
        dgamma = (torch.zeros_like(gamma) if dgamma is None
                  else dgamma.reshape(gamma.shape).to(gamma.dtype))
        return da.reshape(a.shape).to(a.dtype), dw, dgamma, None, None, None, None


def _column_grads(g, aq, wq, group, *, betas, a, amax, gamma, bits_g, bits_a, bits_w,
                  per_sample_act_scales=False, cuts=None):
    """dA (E, M, K), dW (E, K, N) and the dgammas (E,) of a stack of E
    column-parallel products (this rank's N columns of each G (E, M, N)
    and Wq (E, K, N), the input whole on each rank; a linear is a stack of
    one, an expert linear's experts each its own product): K2 chained
    across ``group`` at whole 128-chunks a rank, every product's running
    sum in one chain (each product's K2 continuing from its slice, the
    PRC epilogue on the last rank), else over G and Wq gathered whole; K3
    local.  ``betas``: each product's G scale; ``a`` (E, M, K) and
    ``amax`` (E,) the PRC epilogue's (dgammas None without them).
    ``cuts``: each rank's pieces of N (``planner.ShardingPlan.model_cuts``;
    an ssm's packed in_proj, whose pieces interleave and whose B and C
    columns every rank holds): G and Wq are gathered and placed at their
    offsets in the whole N, whatever the width, and Gq is cut back to this
    rank's pieces for K3."""
    e, m, n = g.shape
    k = wq.shape[1]
    prc = amax is not None

    def da_kw(i, last):  # the PRC epilogue on the last rank only
        kw = dict(bits_g=bits_g, bits_w=bits_w, beta_g=betas[i])
        if prc and last:
            kw.update(a=a[i], clip_t=amax[i] * gamma)
        return kw

    if cuts is None and n % CANONICAL_BK == 0:
        gq = [ops.grad_prepass(g[i], bits_g, betas[i]) for i in range(e)]

        def partial(start, last):
            outs = []
            for i in range(e):
                da, rows = ops.grad_da_matmul(g[i], wq[i], gq=gq[i], last=last,
                                              start=None if start is None else start[i],
                                              **da_kw(i, last))
                outs.append(torch.cat([da.reshape(-1), rows]) if rows is not None else da)
            return torch.stack(outs)

        out = collectives.chained(partial, (e, m, k), g.device, group,
                                  last_shape=(e, m * k + m) if prc else None,
                                  counter="bwd_folds").reshape(e, -1)
        da = out[:, :m * k].reshape(e, m, k)
        rows = out[:, m * k:] if prc else None
    else:
        collectives.stats["bwd_gathers"] += 1
        r = dist.get_rank(group)
        if cuts is None:  # an even split in rank order
            cuts = tuple(((q * n, n),) for q in range(dist.get_world_size(group)))
        g_all = ShardingPlan.untake(collectives.all_gather(g, group), (2, cuts))
        w_all = ShardingPlan.untake(collectives.all_gather(wq.to(torch.float32), group),
                                    (2, cuts))
        das, rows, gq = [], [], []
        for i in range(e):
            gq_all = ops.grad_prepass(g_all[i], bits_g, betas[i])
            da, rw = ops.grad_da_matmul(g_all[i], w_all[i], gq=gq_all, **da_kw(i, True))
            das.append(da)
            rows.append(rw)
            gq.append(None if gq_all is None else ShardingPlan.take(gq_all, (1, cuts[r])))
        da = torch.stack(das)
        rows = torch.stack(rows) if prc else None
    dw = torch.stack([ops.grad_dw_matmul(g[i], aq[i], bits_g=bits_g, bits_a=bits_a,
                                         beta_g=betas[i], gq=gq[i],
                                         per_sample_act_scales=per_sample_act_scales)
                      for i in range(e)])
    dgs = None if rows is None else torch.stack([halves_fold(rows[i]) * amax[i]
                                                 for i in range(e)])
    return da, dw, dgs


class _RowParallel(torch.autograd.Function):
    """a[..., K_r] @ w[K_r, N], K split over ``group`` (:func:`_row_parallel`)."""

    @staticmethod
    def forward(ctx, a, w, gamma, policy: QuantPolicy, group):
        k, n = w.shape
        aq = _quantize_a(a, gamma, policy, row_group=group).reshape(-1, k)
        wq = _quantize_w(w, policy)
        out = collectives.ordered_fold(
            lambda start: ops.pot_value_matmul(aq, wq, bits_a=policy.bits_a,
                                               bits_w=policy.bits_w, start=start),
            (aq.shape[0], n), a.device, group)
        ctx.policy, ctx.group = policy, group
        ctx.save_for_backward(a, aq, wq, gamma)
        return out.reshape(*a.shape[:-1], n).to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        a, aq, wq, gamma = ctx.saved_tensors
        policy, group = ctx.policy, ctx.group
        k, n = wq.shape
        g2 = g.to(torch.float32).reshape(-1, n)
        bits_g = policy.bits_for("g", False)
        beta_g = _grad_scale(g2, bits_g)  # G is whole on every model rank
        gq = ops.grad_prepass(g2, bits_g, beta_g)
        kw = dict(bits_g=bits_g, bits_w=policy.bits_w, beta_g=beta_g, gq=gq)
        dgamma = torch.zeros_like(gamma)
        if policy.prc_enabled:
            a2 = a.to(torch.float32).reshape(-1, k)
            amax = _global_amax(a2.abs().amax(), True, group)  # the forward's
            got = []

            def partial(rows_start, last):
                da, rows = ops.grad_da_matmul(g2, wq, a=a2, clip_t=amax * gamma,
                                              rows_start=rows_start, **kw)
                got.append(da)
                return rows

            rows = collectives.chained(partial, (g2.shape[0],), a.device, group,
                                       counter="bwd_folds")
            da = got[0]
            dgamma = (halves_fold(rows) * amax).reshape(gamma.shape).to(gamma.dtype)
        else:
            da, _ = ops.grad_da_matmul(g2, wq, **kw)
        dw = ops.grad_dw_matmul(g2, aq, bits_g=bits_g, bits_a=policy.bits_a, beta_g=beta_g,
                                per_sample_act_scales=policy.per_sample_act_scales, gq=gq)
        return da.reshape(a.shape).to(a.dtype), dw, dgamma, None, None


def _row_parallel(a, w, gamma, policy: QuantPolicy, group) -> torch.Tensor:
    """a[..., K_r] @ w[K_r, N] with K split over ``group`` at whole
    128-chunks, in rank order: global activation scales, then K1's fold
    chained across the ranks; the backward of the module docstring.  Its
    weights are prequantized whole (served, or the training step's shadow)
    or given with the whole matrix's statistics (:func:`whole_stats`: the
    self-draft's): a shard's own WBC mean and scale would not be the
    matrix's."""
    if not policy.weights_prequantized and weight_key(w) not in _W_STATS:
        raise ValueError("a row-parallel mf_linear needs weights prequantized whole or "
                         "their whole matrix's statistics (a shard's own WBC mean and "
                         "scale would not be the matrix's)")
    return _RowParallel.apply(a, w, gamma, policy, group)


def _plain_linear(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The unquantized a @ w in a's dtype; decode rows (B, 1, K) one (1, K)
    @ (K, N) product a row, so a row's reduction never depends on the
    batch size."""
    w_ = w.to(a.dtype)
    if a.dim() == 3 and a.shape[1] == 1:
        return torch.stack([torch.matmul(r, w_) for r in a])
    return torch.matmul(a, w_)


def _plain_row_parallel(a: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """The unquantized a[..., K_r] @ w[K_r, N], K split over ``group``:
    each rank's partial product (:func:`_plain_linear`) added in float32
    to the running sum of the ranks before it, in rank order
    (``collectives.ordered_fold``), so every rank holds the same sum.  It
    adds the partials in another order than one rank's product does, so
    it is that product within float32 rounding, not bit for bit."""
    shape = a.shape[:-1] + (w.shape[-1],)

    def partial(start):
        part = _plain_linear(a, w).to(torch.float32)
        return part if start is None else start + part

    return collectives.ordered_fold(partial, shape, a.device, group).to(a.dtype)


def mf_linear(
    a: torch.Tensor,
    w: torch.Tensor,
    gamma: Optional[Union[torch.Tensor, float]] = None,
    *,
    policy: QuantPolicy,
    is_last: bool = False,
    row_group=None,
    col_group=None,
    col_cuts=None,
) -> torch.Tensor:
    """Quantized (or plain, if ``policy.enabled=False``) a[..., K] @ w[K, N].

    ``is_last`` selects the last layer's gradient bit-width
    (``policy.bits_g_last``) in the backward.  dW comes back in float32.
    ``row_group`` (a process group): K is split over its ranks, this
    rank's slice in ``a`` and ``w``; the result is the whole product on
    every rank (:func:`_row_parallel`).  ``col_group``: N is split over its
    ranks, ``a`` whole on each and ``w`` this rank's columns; the result is
    this rank's columns, and the backward chains K2 across the ranks
    (module docstring); with ``col_cuts`` (each rank's pieces of N, an
    index set: an ssm's packed in_proj) ``w`` holds this rank's pieces and
    the backward computes dA over G and Wq placed whole (:func:`_column_grads`).
    Unquantized, a ``row_group`` product adds the ranks' partial products
    in rank order (:func:`_plain_row_parallel`; no backward)."""
    if not policy.enabled:
        if row_group is not None:
            return _plain_row_parallel(a, w, row_group)
        return _plain_linear(a, w)
    if gamma is None:
        gamma = policy.ratio_clip_init or 1.0
    if not torch.is_tensor(gamma):
        # a fill on the device, not a host-to-device copy (no host sync)
        gamma = torch.full((), gamma, dtype=torch.float32, device=a.device)
    if row_group is not None:
        return _row_parallel(a, w, gamma, policy, row_group)
    return _MFLinear.apply(a, w, gamma, policy, is_last, col_group, col_cuts)


class _MFExpertLinear(torch.autograd.Function):
    """a[E, T, K] @ w[E, K, N], scales per expert (axes (1, 2)): forward
    through one K1 launch, backward through K2 and K3 once per expert.
    Under data-parallel training an expert's rows lie on every data rank:
    its activation amax, PRC threshold and max|G| are global maxima.

    On a model axis (:func:`mf_expert_linear`): ``expert_group``, this
    rank's experts of the layer's whole ones (EP); their scales and
    launches are local, and the per-expert dgammas of every rank are
    all-gathered in rank order (expert order) and folded on each, so the
    shared gamma's gradient is one rank's.  ``col_group``: every expert's
    N split (TP; :func:`_expert_column_grads`)."""

    @staticmethod
    def forward(ctx, a, w, gamma, policy: QuantPolicy, expert_group=None, col_group=None):
        aq = _quantize_a(a, gamma, policy, axes=(1, 2), rows_split=True)
        wq = _quantize_w(w, policy, axes=(1, 2))
        out = _pot_bmm(aq, wq, policy)
        ctx.policy, ctx.expert_group, ctx.col_group = policy, expert_group, col_group
        ctx.save_for_backward(a, aq, wq, gamma)
        return out.to(a.dtype)

    @staticmethod
    def backward(ctx, g):
        a, aq, wq, gamma = ctx.saved_tensors
        policy, col = ctx.policy, ctx.col_group
        dgroup = actshard.batch_group()
        g = g.to(torch.float32)
        # a rank holds some of each expert's columns under TP: max|G| over
        # the model ranks too
        gmax = collectives.all_reduce_max(
            collectives.all_reduce_max(g.abs().amax(dim=(1, 2)), dgroup), col)
        amax = None
        if policy.prc_enabled:
            amax = collectives.all_reduce_max(a.to(torch.float32).abs().amax(dim=(1, 2)),
                                              dgroup)
        # experts get bits_g, never bits_g_last (the reference's choice)
        kw = dict(gmax=gmax, a=a if policy.prc_enabled else None, gamma=gamma, amax=amax,
                  bits_g=policy.bits_g, bits_a=policy.bits_a, bits_w=policy.bits_w)
        if col is None:
            da, dw, dgs = ops.potq_expert_grad_matmuls(g, aq, wq, **kw)
        else:
            da, dw, dgs = _expert_column_grads(g, aq, wq, col, **kw)
        if dgs is None:
            dgamma = torch.zeros_like(gamma)
        else:  # the experts' dgammas in expert order, folded
            dgamma = halves_fold(torch.cat(collectives.all_gather(dgs, ctx.expert_group)))
        return (da.to(a.dtype), dw, dgamma.reshape(gamma.shape).to(gamma.dtype), None, None,
                None)


def _expert_column_grads(g, aq, wq, group, *, gmax, a, gamma, amax, bits_g, bits_a, bits_w):
    """dA, dW and the per-expert dgammas of an expert linear whose N is
    split over ``group``: :func:`_column_grads` over its experts, each
    with its own G scale from ``gmax``."""
    return _column_grads(g, aq, wq, group,
                         betas=[potq.beta_of_amax(gmax[i], bits_g) for i in range(g.shape[0])],
                         a=None if a is None else a.to(torch.float32), amax=amax,
                         gamma=gamma, bits_g=bits_g, bits_a=bits_a, bits_w=bits_w)


def _expert_per_slot(a, w, gamma, policy: QuantPolicy) -> torch.Tensor:
    """a[E, G, C, K] @ w[E, K, N] with activation scales per (expert, slot)
    over (C, K) and weight scales per expert: the reference's vmap of
    ``mf_expert_linear`` over the slot axis G, as ONE K1 launch over the
    (E, G*C, K) rows (each row still carries one beta)."""
    e, g, c, k = a.shape
    aq = _quantize_a(a, gamma, policy, axes=(2, 3))
    wq = _quantize_w(w, policy, axes=(1, 2))
    out = _pot_bmm(aq.reshape(e, g * c, k), wq, policy)
    return out.reshape(e, g, c, -1).to(a.dtype)


def mf_expert_linear(
    a: torch.Tensor,
    w: torch.Tensor,
    gamma: Optional[Union[torch.Tensor, float]] = None,
    *,
    policy: QuantPolicy,
    per_slot: bool = False,
    expert_group=None,
    col_group=None,
) -> torch.Tensor:
    """Quantized (or plain, if ``policy.enabled=False``) a[E, T, K] @
    w[E, K, N], each expert its own layer.  ``per_slot`` takes a[E, G, C,
    K] and gives every (expert, slot) its own activation scale (serving's
    per-slot dispatch); it has no backward, as the reference only runs it
    in serving steps.  dW comes back in float32.  The backward's groups
    (tensor-parallel training, :class:`_MFExpertLinear`):
    ``expert_group``, the layer's experts split over its ranks (``a`` and
    ``w`` this rank's); ``col_group``, every expert's N split over its
    ranks (``w`` this rank's columns, ``a`` whole on each)."""
    if not policy.enabled:
        # one (rows, K) @ (K, N) product per expert (and slot), so a
        # matrix's reduction never depends on the batch around it
        w_ = w.to(a.dtype)
        if per_slot:
            return torch.stack([torch.stack([torch.matmul(r, w_[i]) for r in a[i]])
                                for i in range(a.shape[0])])
        return torch.stack([torch.matmul(a[i], w_[i]) for i in range(a.shape[0])])
    if gamma is None:
        gamma = policy.ratio_clip_init or 1.0
    if not torch.is_tensor(gamma):
        gamma = torch.tensor(gamma, dtype=torch.float32, device=a.device)
    if per_slot:
        if torch.is_grad_enabled() and (a.requires_grad or w.requires_grad):
            raise ValueError("mf_expert_linear(per_slot=True) has no backward")
        return _expert_per_slot(a, w, gamma, policy)
    return _MFExpertLinear.apply(a, w, gamma, policy, expert_group, col_group)


# ---------------------------------------------------------------------------
# mf_act_dot: activation x activation products (attention), opt-in
# ---------------------------------------------------------------------------

def _qact(x: torch.Tensor, bits: int, axes=None, group=None,
          rows_split: bool = False) -> torch.Tensor:
    """x PoT-quantized at ``bits`` under one scale per ``axes`` group (the
    whole tensor for None), as exact values in bf16; no PRC clip.  The
    amax is global (:func:`_global_amax`) over the data ranks when
    ``rows_split`` and over ``group``'s ranks."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax() if axes is None else x32.abs().amax(dim=axes, keepdim=True)
    amax = _global_amax(amax, rows_split, group)
    return potq.pot_quantize(x32, bits, potq.beta_of_amax(amax, bits)).to(_BF16)


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` summed over the dims that broadcasting added or widened, back
    to ``shape``."""
    lead = t.dim() - len(shape)
    if lead:
        t = t.sum(dim=tuple(range(lead)))
    wide = tuple(i for i, n in enumerate(shape) if n == 1 and t.shape[i] != 1)
    return t.sum(dim=wide, keepdim=True) if wide else t


class _MFActDot(torch.autograd.Function):
    """x[..., M, K] @ y[..., K, N] over PoT-quantized operands (batch dims
    broadcast); the backward is the reference's ``_mf_act_dot_bwd``.
    Each scale is global over the ranks that hold part of its group
    (:func:`mf_act_dot`)."""

    @staticmethod
    def forward(ctx, x, y, policy: QuantPolicy, group):
        xa, ya = _sample_axes(policy, x, None), _sample_axes(policy, y, None)
        xq = _qact(x, policy.bits_a, xa, group, rows_split=xa is None)
        yq = _qact(y, policy.bits_a, ya, group, rows_split=ya is None)
        ctx.policy, ctx.group, ctx.dtypes = policy, group, (x.dtype, y.dtype)
        ctx.save_for_backward(xq, yq)
        # PoT products are exact in float32 (TF32 is off on the card)
        return torch.matmul(xq.to(torch.float32), yq.to(torch.float32)).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        xq, yq = ctx.saved_tensors
        # G quantized once, one scale for the whole tensor
        gq = _qact(g, ctx.policy.bits_g, None, ctx.group, rows_split=True).to(torch.float32)
        dx = _sum_to(torch.matmul(gq, yq.to(torch.float32).transpose(-1, -2)), xq.shape)
        dy = _sum_to(torch.matmul(xq.to(torch.float32).transpose(-1, -2), gq), yq.shape)
        # rounded to bf16 as the reference's rule does, in the primal's dtype
        return (dx.to(_BF16).to(ctx.dtypes[0]), dy.to(_BF16).to(ctx.dtypes[1]), None,
                None)


def mf_act_dot(x: torch.Tensor, y: torch.Tensor, *, policy: QuantPolicy,
               group=None) -> torch.Tensor:
    """x[..., M, K] @ y[..., K, N], batch dims broadcast: through PoT
    quantization under ``policy.quantize_attention`` (one activation scale
    per tensor, per leading-dim sample under ``per_sample_act_scales``),
    otherwise the plain product.

    On a sharded plan each scale is taken over its whole group: over
    ``group`` (the model ranks, where the attention's heads are split and
    each rank holds the others' heads as zeros or as the probabilities of
    zero scores, which never exceed a real head's largest,
    ``models/transformer._heads_whole``), and, for a per-tensor group,
    over the data ranks that split the batch rows (training); the
    backward's G scale over both.  Max is exact, so every quantized value
    is one rank's."""
    if policy.enabled and policy.quantize_attention:
        return _MFActDot.apply(x, y, policy, group)
    return torch.matmul(x, y)


# ---------------------------------------------------------------------------
# mf_conv2d: convolution as im2col + MF-MAC (the paper's CNN linear layers)
# ---------------------------------------------------------------------------

def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """JAX's "SAME" split: the output is ceil(size / stride) wide, the
    total pad goes one more to the end than to the start when odd."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_patches(x: torch.Tensor, kh: int, kw: int, stride: int = 1,
                 padding: str = "SAME") -> torch.Tensor:
    """im2col of x (B, H, W, Cin): (B, Ho, Wo, Cin*KH*KW), features
    Cin-major, element for element the reference's
    ``conv_general_dilated_patches`` (pads of zeros, explicit and, at
    stride 2, possibly asymmetric)."""
    b, h, w, c = x.shape
    if padding == "SAME":
        ph, pw = _same_pads(h, kh, stride), _same_pads(w, kw, stride)
    elif padding == "VALID":
        ph = pw = (0, 0)
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    ho = (h + ph[0] + ph[1] - kh) // stride + 1
    wo = (w + pw[0] + pw[1] - kw) // stride + 1
    cols = F.unfold(xc, (kh, kw), stride=stride)  # (B, Cin*KH*KW, Ho*Wo)
    return cols.transpose(1, 2).reshape(b, ho, wo, c * kh * kw)


def mf_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    gamma: Optional[Union[torch.Tensor, float]] = None,
    *,
    policy: QuantPolicy,
    stride: int = 1,
    padding: str = "SAME",
    is_last: bool = False,
) -> torch.Tensor:
    """2-D convolution of x (B, H, W, Cin) by w (KH, KW, Cin, Cout) through
    the quantized MAC path: im2col, then ``mf_linear`` of the patches by
    the (Cin*KH*KW, Cout) filter matrix, one layer-wise scale for W and one
    for A.  Returns (B, Ho, Wo, Cout)."""
    kh, kw, cin, cout = w.shape
    patches = conv_patches(x, kh, kw, stride, padding)
    wm = w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
    return mf_linear(patches, wm, gamma, policy=policy, is_last=is_last)
