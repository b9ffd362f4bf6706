"""The embedding-training steps, in PyTorch.

The JAX package's ``nlp/kernels.py`` written out eagerly: gathers, the
closed-form SGNS / hierarchical-softmax / CBOW / GloVe gradients, and
count-normalised scatter updates. Every float segment-sum goes through
the hand-written ``scatter_add`` kernel (``perf/kernels/scatter_add.py``)
on a CUDA tensor, and through its plain version on a CPU tensor; the
order of operations is the JAX package's, so the scatters agree bitwise
and the steps within float32 rounding of the sums (torch's and XLA's
einsums add in other orders).

The tables are updated **in place** (the JAX steps donate them) and
returned, so ``syn0, syn1, loss = step(syn0, syn1, ...)`` reads as it does
there. Losses are 0-d tensors on the tables' device: reading one
synchronises, so callers gather them and read once per epoch.

The TPU-only one-hot matrix-product route of ``_scatter_mean_update`` (an
XLA workaround for slow TPU scatters) has no counterpart: the kernel is
the route on the card.

The random draws of the device paths are split from the steps:
:func:`corpus_draws` makes a batch's pairs and shared negatives with a
``torch.Generator`` (Philox on the card, not JAX's threefry), and
:func:`sgns_corpus_step` trains on given tensors, so a test can feed both
packages the same draws.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.perf.kernels.scatter_add import scatter_add

__all__ = ["sgns_step", "hs_step", "cbow_step", "cbow_hs_step", "sgns_infer_step",
           "cbow_infer_step", "glove_step", "sgns_scan", "hs_scan", "cbow_scan",
           "cbow_hs_scan", "sgns_macro_step", "corpus_draws", "offset_cdf",
           "sgns_corpus_step"]

_EPS = 1e-7


def _scatter_mean_update(table, idx, grads, weights, lr):
    """table += lr * segment_mean(grads over idx), in place.

    idx (N,) int32 rows, grads (N, D), weights (N,) 0/1 validity. Rows no
    index names keep count 0 and get no update. The counts sum 0/1 values in
    float32, exact in any order, so they stay plain tensor code; every row
    of grads, masked ones too, goes through the kernel, as every row goes
    through ``.at[].add`` in the JAX package (a masked row adds ±0.0)."""
    cnt = torch.zeros(table.shape[0], dtype=table.dtype, device=table.device)
    cnt.index_add_(0, idx, weights)
    scale = (weights / cnt.clamp_min(1.0)[idx])[:, None]
    return scatter_add(table, idx, lr * grads * scale)


def _lr(lr) -> float:
    """The JAX package passes ``np.float32(lr)``: round to float32 first."""
    return float(np.float32(lr))


def _nll(s_pos, s_neg, wmask):
    nll = -(torch.log(s_pos + _EPS) + torch.sum(torch.log(1.0 - s_neg + _EPS), dim=-1))
    return torch.sum(nll * wmask) / torch.clamp_min(torch.sum(wmask), 1.0)


def _bce(codes, s, mask):
    target = 1.0 - codes.to(s.dtype)
    bce = -(target * torch.log(s + _EPS) + (1.0 - target) * torch.log(1.0 - s + _EPS))
    return torch.sum(bce * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def sgns_step(syn0, syn1neg, centers, contexts, negs, wmask, lr):
    """Skip-gram negative sampling (JAX ``kernels.sgns_step``).

    syn0 / syn1neg (V, D); centers, contexts (B,) int32; negs (B, K) int32;
    wmask (B,) 1/0. The context word's input vector trains against the
    center word's output path."""
    lr = _lr(lr)
    v = syn0[contexts]
    u_pos = syn1neg[centers]
    u_neg = syn1neg[negs]
    s_pos = torch.sigmoid(torch.sum(v * u_pos, dim=-1))
    s_neg = torch.sigmoid(torch.einsum("bd,bkd->bk", v, u_neg))
    g_pos = (1.0 - s_pos) * wmask
    g_neg = -s_neg * wmask[:, None]
    dv = g_pos[:, None] * u_pos + torch.einsum("bk,bkd->bd", g_neg, u_neg)
    du_pos = g_pos[:, None] * v
    du_neg = g_neg[..., None] * v[:, None, :]
    B, K = negs.shape
    D = v.shape[-1]
    syn0 = _scatter_mean_update(syn0, contexts, dv, wmask, lr)
    out_idx = torch.cat([centers, negs.reshape(-1)])
    out_grads = torch.cat([du_pos, du_neg.reshape(B * K, D)])
    out_w = torch.cat([wmask, torch.repeat_interleave(wmask, K)])
    syn1neg = _scatter_mean_update(syn1neg, out_idx, out_grads, out_w, lr)
    return syn0, syn1neg, _nll(s_pos, s_neg, wmask)


def _path_mask(lengths, L, dtype):
    return (torch.arange(L, device=lengths.device)[None, :] < lengths[:, None]).to(dtype)


def hs_step(syn0, syn1, contexts, codes, points, lengths, lr):
    """Skip-gram hierarchical softmax (JAX ``kernels.hs_step``): codes /
    points (B, L) of the center word's Huffman path, lengths (B,); padded
    batch rows carry length 0."""
    lr = _lr(lr)
    v = syn0[contexts]
    u = syn1[points]
    B, L = codes.shape
    mask = _path_mask(lengths, L, v.dtype)
    s = torch.sigmoid(torch.einsum("bd,bld->bl", v, u))
    g = (1.0 - codes.to(v.dtype) - s) * mask
    dv = torch.einsum("bl,bld->bd", g, u)
    du = g[..., None] * v[:, None, :]
    D = v.shape[-1]
    valid = (lengths > 0).to(v.dtype)
    syn0 = _scatter_mean_update(syn0, contexts, dv, valid, lr)
    syn1 = _scatter_mean_update(syn1, points.reshape(-1), du.reshape(B * L, D),
                                mask.reshape(-1), lr)
    return syn0, syn1, _bce(codes, s, mask)


def _bag_mean(syn0, context_bags, bag_mask):
    bags = syn0[context_bags]
    m = bag_mask[..., None]
    denom = torch.clamp_min(torch.sum(bag_mask, dim=-1, keepdim=True), 1.0)
    return torch.sum(bags * m, dim=1) / denom, m, denom


def cbow_step(syn0, syn1neg, centers, context_bags, bag_mask, negs, wmask, lr):
    """CBOW with negative sampling (JAX ``kernels.cbow_step``): the mean of
    the context bag (B, W) predicts the center."""
    lr = _lr(lr)
    h, m, denom = _bag_mean(syn0, context_bags, bag_mask)
    u_pos = syn1neg[centers]
    u_neg = syn1neg[negs]
    s_pos = torch.sigmoid(torch.sum(h * u_pos, dim=-1))
    s_neg = torch.sigmoid(torch.einsum("bd,bkd->bk", h, u_neg))
    g_pos = (1.0 - s_pos) * wmask
    g_neg = -s_neg * wmask[:, None]
    dh = g_pos[:, None] * u_pos + torch.einsum("bk,bkd->bd", g_neg, u_neg)
    du_pos = g_pos[:, None] * h
    du_neg = g_neg[..., None] * h[:, None, :]
    B, K = negs.shape
    D = h.shape[-1]
    W = context_bags.shape[1]
    dbag = (dh[:, None, :] * m) / denom[..., None]
    bag_w = (bag_mask * wmask[:, None]).reshape(-1)
    syn0 = _scatter_mean_update(syn0, context_bags.reshape(-1), dbag.reshape(B * W, D),
                                bag_w, lr)
    out_idx = torch.cat([centers, negs.reshape(-1)])
    out_grads = torch.cat([du_pos, du_neg.reshape(B * K, D)])
    out_w = torch.cat([wmask, torch.repeat_interleave(wmask, K)])
    syn1neg = _scatter_mean_update(syn1neg, out_idx, out_grads, out_w, lr)
    return syn0, syn1neg, _nll(s_pos, s_neg, wmask)


def cbow_hs_step(syn0, syn1, centers_codes, centers_points, centers_lengths,
                 context_bags, bag_mask, lr):
    """CBOW with hierarchical softmax (JAX ``kernels.cbow_hs_step``): the
    bag mean walks the center word's Huffman path."""
    lr = _lr(lr)
    h, m, denom = _bag_mean(syn0, context_bags, bag_mask)
    u = syn1[centers_points]
    B, L = centers_codes.shape
    mask = _path_mask(centers_lengths, L, h.dtype)
    s = torch.sigmoid(torch.einsum("bd,bld->bl", h, u))
    g = (1.0 - centers_codes.to(h.dtype) - s) * mask
    dh = torch.einsum("bl,bld->bd", g, u)
    du = g[..., None] * h[:, None, :]
    D = h.shape[-1]
    W = context_bags.shape[1]
    dbag = (dh[:, None, :] * m) / denom[..., None]
    valid = (centers_lengths > 0).to(h.dtype)
    bag_w = (bag_mask * valid[:, None]).reshape(-1)
    syn0 = _scatter_mean_update(syn0, context_bags.reshape(-1), dbag.reshape(B * W, D),
                                bag_w, lr)
    syn1 = _scatter_mean_update(syn1, centers_points.reshape(-1), du.reshape(B * L, D),
                                mask.reshape(-1), lr)
    return syn0, syn1, _bce(centers_codes, s, mask)


def sgns_infer_step(docvec, syn1neg, centers, negs, wmask, lr):
    """DBOW inference (JAX ``kernels.sgns_infer_step``): only the document
    vector (D,) trains; returns a new vector, the tables are not touched."""
    lr = _lr(lr)
    u_pos = syn1neg[centers]
    u_neg = syn1neg[negs]
    s_pos = torch.sigmoid(u_pos @ docvec)
    s_neg = torch.sigmoid(torch.einsum("bkd,d->bk", u_neg, docvec))
    g_pos = (1.0 - s_pos) * wmask
    g_neg = -s_neg * wmask[:, None]
    dv = torch.einsum("b,bd->d", g_pos, u_pos) + torch.einsum("bk,bkd->d", g_neg, u_neg)
    docvec = docvec + lr * dv / torch.clamp_min(torch.sum(wmask), 1.0)
    return docvec, _nll(s_pos, s_neg, wmask)


def cbow_infer_step(docvec, syn0, syn1neg, centers, context_bags, bag_mask, negs,
                    wmask, lr):
    """DM inference (JAX ``kernels.cbow_infer_step``): the document vector
    joins each context bag; only it trains."""
    lr = _lr(lr)
    bags = syn0[context_bags]
    m = bag_mask[..., None]
    count = torch.sum(bag_mask, dim=-1, keepdim=True) + 1.0
    h = (torch.sum(bags * m, dim=1) + docvec[None, :]) / count
    u_pos = syn1neg[centers]
    u_neg = syn1neg[negs]
    s_pos = torch.sigmoid(torch.sum(h * u_pos, dim=-1))
    s_neg = torch.sigmoid(torch.einsum("bd,bkd->bk", h, u_neg))
    g_pos = (1.0 - s_pos) * wmask
    g_neg = -s_neg * wmask[:, None]
    dh = g_pos[:, None] * u_pos + torch.einsum("bk,bkd->bd", g_neg, u_neg)
    dv = torch.sum(dh / count, dim=0)
    docvec = docvec + lr * dv / torch.clamp_min(torch.sum(wmask), 1.0)
    return docvec, _nll(s_pos, s_neg, wmask)


def _scatter_vec(vec, idx, upd):
    """A (V,) vector through the kernel, as a (V, 1) table."""
    scatter_add(vec.view(-1, 1), idx, upd[:, None])
    return vec


def glove_step(w, wc, b, bc, gw, gwc, gb, gbc, rows, cols, logx, weight, lr):
    """AdaGrad step on the GloVe objective (JAX ``kernels.glove_step``).
    All eight ``.at[].add`` of the JAX step are kernel launches here, in its
    order (the accumulators first, then the tables, which read them)."""
    lr = _lr(lr)
    wi = w[rows]
    wj = wc[cols]
    diff = torch.sum(wi * wj, dim=-1) + b[rows] + bc[cols] - logx
    fdiff = weight * diff
    loss = 0.5 * torch.mean(fdiff * diff)
    dwi = fdiff[:, None] * wj
    dwj = fdiff[:, None] * wi
    scatter_add(gw, rows, dwi * dwi)
    scatter_add(gwc, cols, dwj * dwj)
    _scatter_vec(gb, rows, fdiff * fdiff)
    _scatter_vec(gbc, cols, fdiff * fdiff)
    scatter_add(w, rows, -lr * dwi / torch.sqrt(gw[rows] + _EPS))
    scatter_add(wc, cols, -lr * dwj / torch.sqrt(gwc[cols] + _EPS))
    _scatter_vec(b, rows, -lr * fdiff / torch.sqrt(gb[rows] + _EPS))
    _scatter_vec(bc, cols, -lr * fdiff / torch.sqrt(gbc[cols] + _EPS))
    return w, wc, b, bc, gw, gwc, gb, gbc, loss


def _scanned(step_fn):
    """The JAX ``*_scan`` variants: one call over a stack of (NB, B, ...)
    batches, a loop here; returns the tables and the (NB,) losses."""
    def scan_fn(syn0, syn1, *batches_and_lr):
        *batches, lr = batches_and_lr
        losses = []
        for inp in zip(*batches):
            syn0, syn1, loss = step_fn(syn0, syn1, *inp, lr)
            losses.append(loss)
        return syn0, syn1, torch.stack(losses)
    scan_fn.__doc__ = f"``{step_fn.__name__}`` over a leading batch axis."
    return scan_fn


sgns_scan = _scanned(sgns_step)
hs_scan = _scanned(hs_step)
cbow_scan = _scanned(cbow_step)
cbow_hs_scan = _scanned(cbow_hs_step)


def sgns_macro_step(syn0, syn1neg, neg_table, centers, contexts, gen, K, lr):
    """JAX ``kernels.sgns_macro_step``: NB full batches of pairs (NB, B),
    each with (B, K) negatives drawn on the device from the unigram table
    with ``gen``. Returns the tables and the (NB,) losses."""
    nb, b = centers.shape
    wm = torch.ones(b, dtype=syn0.dtype, device=syn0.device)
    losses = []
    for i in range(nb):
        draw = torch.randint(0, neg_table.shape[0], (b, K), generator=gen,
                             device=neg_table.device)
        syn0, syn1neg, loss = sgns_step(syn0, syn1neg, centers[i], contexts[i],
                                        neg_table[draw], wm, lr)
        losses.append(loss)
    return syn0, syn1neg, torch.stack(losses)


# ---------------------------------------------------------------------------
# Corpus-resident SGNS (JAX ``kernels.sgns_corpus_macro_step``): the encoded
# corpus lives on the device, which draws each batch's (center, context)
# pairs and K shared negatives itself. The pair distribution is the host
# enumeration's: position ~ U[0, T), side ~ ±1, offset d in 1..W with
# P(d) ∝ W - d + 1 (a dynamic window r ~ U[1, W] trains offset d when
# d <= r); a pair that crosses a sentence or the true length is masked.


def offset_cdf(W: int, device) -> torch.Tensor:
    """Cumulative weights of d = 1..W, weights W, W-1, ..., 1 (int64)."""
    return torch.cumsum(torch.arange(W, 0, -1, dtype=torch.int64), 0).to(device)


def corpus_draws(gen, corpus, sid, neg_table, cdf, B: int, K: int,
                 keep: Optional[torch.Tensor] = None):
    """One batch's draws: (centers (B,) int32, contexts (B,) int32, negs (K,)
    int32, wmask (B,) float32). ``corpus`` / ``sid`` hold the segment's word
    and sentence ids (unpadded: the JAX package pads segments to one length
    for one compiled program, the port has nothing to compile); ``cdf`` is
    :func:`offset_cdf`. ``keep`` (V,) is the subsampling keep-probability
    (it drops pairs by endpoint, an approximation the JAX package makes
    too)."""
    dev = corpus.device
    t = corpus.shape[0]
    pos = torch.randint(0, t, (B,), generator=gen, device=dev)
    w = cdf.shape[0]
    u = torch.randint(0, w * (w + 1) // 2, (B,), generator=gen, device=dev)
    d = 1 + torch.searchsorted(cdf, u, right=True)
    side = torch.where(torch.rand(B, generator=gen, device=dev) < 0.5, 1, -1)
    cpos = pos + side * d
    valid = (cpos >= 0) & (cpos < t)
    cposc = cpos.clamp(0, t - 1)
    valid &= sid[pos] == sid[cposc]
    centers = corpus[pos].to(torch.int32)
    contexts = corpus[cposc].to(torch.int32)
    if keep is not None:
        valid &= torch.rand(B, generator=gen, device=dev) < keep[centers]
        valid &= torch.rand(B, generator=gen, device=dev) < keep[contexts]
    negs = neg_table[torch.randint(0, neg_table.shape[0], (K,), generator=gen,
                                   device=dev)].to(torch.int32)
    return centers, contexts, negs, valid.to(torch.float32)


def sgns_corpus_step(s0, s1, centers, contexts, negs, wmask, lr):
    """SGNS on one drawn batch with K shared negatives (the body of JAX
    ``sgns_corpus_macro_step``): the two count-normalised updates, then the
    shared negatives' dense accumulation added through the kernel. Three
    ``scatter_add`` launches."""
    lr = _lr(lr)
    v = s0[contexts]
    u_pos = s1[centers]
    u_neg = s1[negs]
    s_pos = torch.sigmoid(torch.sum(v * u_pos, -1))
    s_neg = torch.sigmoid(v @ u_neg.T)
    g_pos = (1.0 - s_pos) * wmask
    g_neg = -s_neg * wmask[:, None]
    dv = g_pos[:, None] * u_pos + g_neg @ u_neg
    du_pos = g_pos[:, None] * v
    s0 = _scatter_mean_update(s0, contexts, dv, wmask, lr)
    s1 = _scatter_mean_update(s1, centers, du_pos, wmask, lr)
    npairs = torch.clamp_min(torch.sum(wmask), 1.0)
    s1 = scatter_add(s1, negs, lr * (g_neg.T @ v) / npairs)
    return s0, s1, _nll(s_pos, s_neg, wmask)
