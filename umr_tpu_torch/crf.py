"""Dense-CRF mean-field refinement for SCOPS part probability maps.

Parity target: the reference's ``denseCRF`` utility
(ref: nnutils/scops_utils.py:97-111) — a pydensecrf DenseCRF2D with a
softmax unary (``unary_from_softmax``), ONE pairwise Gaussian kernel
(``addPairwiseGaussian(sxy=3, compat=5)`` — positional only; the ``img``
argument is accepted but unused, exactly as in the reference), and 5
mean-field iterations.

The reference never calls this function (SCOPS part maps arrive
pre-refined: ``scops_path`` defaults to ``.../dcrf_prob``,
ref data/cub.py:47); it is implemented here for component completeness.

Implementation notes (vs pydensecrf/densecrf):
- mean-field loop follows densecrf's ``DenseCRF::inference``:
  ``Q = softmax(-U)``; per iteration ``Q = softmax(-U + w * filter(Q))``
  with a Potts compatibility (``PottsCompatibility::apply`` is
  ``out = -w * in``, subtracted from the negative energy).
- the Gaussian message pass uses an EXACT truncated separable Gaussian
  over features (x/sxy, y/sxy) with densecrf's NORMALIZE_SYMMETRIC
  (``out = n ⊙ K⊗(n ⊙ in)`` with ``n = (K⊗1)^{-1/2}``), where the
  permutohedral lattice in densecrf *approximates* that same Gaussian.
  This is the one deviation: exact filtering instead of the lattice
  approximation.
- the unary is ``-log(clip(prob, 1e-5, 1))`` (pydensecrf
  ``unary_from_softmax`` with its default clip).

Pure numpy: this is host-side data preprocessing (the reference runs it
inside the dataset pipeline). A copy of umr_tpu/utils/crf.py, so that the
port never imports the JAX package; tests/test_torch_host.py pins it
equal and tests/test_torch_utils.py runs the JAX package's CRF tests on
it.
"""

from __future__ import annotations

import numpy as np


def _gaussian_kernel_1d(sxy: float) -> np.ndarray:
    """Truncated 1-D Gaussian over the feature distance x/sxy.

    Pairwise weight k(i,j) = exp(-||f_i - f_j||^2 / 2) with
    f = position/sxy, separable into per-axis factors
    exp(-(dx/sxy)^2 / 2); truncated at 3*sxy like standard dense-CRF
    filtering support.
    """
    r = int(np.ceil(3.0 * sxy))
    d = np.arange(-r, r + 1, dtype=np.float64)
    return np.exp(-0.5 * (d / sxy) ** 2)


def _filter2d_separable(x: np.ndarray, k1d: np.ndarray) -> np.ndarray:
    """Zero-padded separable 2-D correlation of [C,H,W] with k1d⊗k1d."""
    r = (len(k1d) - 1) // 2
    C, H, W = x.shape
    # rows
    xp = np.zeros((C, H + 2 * r, W), dtype=np.float64)
    xp[:, r:r + H] = x
    rows = np.zeros_like(x, dtype=np.float64)
    for t, w in enumerate(k1d):
        rows += w * xp[:, t:t + H]
    # cols
    xp = np.zeros((C, H, W + 2 * r), dtype=np.float64)
    xp[:, :, r:r + W] = rows
    out = np.zeros_like(rows)
    for t, w in enumerate(k1d):
        out += w * xp[:, :, t:t + W]
    return out


def denseCRF(
    img: np.ndarray | None,
    pred: np.ndarray,
    n_iters: int = 5,
    sxy: float = 3.0,
    compat: float = 5.0,
) -> np.ndarray:
    """Mean-field dense-CRF over softmax maps (ref scops_utils.py:97-111).

    Args:
      img: accepted for signature parity; UNUSED (the reference adds only
        the positional Gaussian kernel, no image-bilateral term).
      pred: [N,H,W] class probability maps (softmax over N).
    Returns:
      [H,W,N] refined probabilities (the reference returns the
      ``(N,H,W) -> transpose(1,2,0)`` layout; preserved).
    """
    del img
    pred = np.asarray(pred, dtype=np.float64)
    N, H, W = pred.shape

    # unary_from_softmax(pred): -log(clip(prob, 1e-5, 1))
    U = -np.log(np.clip(pred, 1e-5, 1.0))

    k1d = _gaussian_kernel_1d(sxy)
    # NORMALIZE_SYMMETRIC: n = (K ⊗ 1)^(-1/2); filter(x) = n*(K⊗(n*x))
    ones = np.ones((1, H, W))
    norm = 1.0 / np.sqrt(_filter2d_separable(ones, k1d) + 1e-20)

    def softmax(logits):
        m = logits.max(axis=0, keepdims=True)
        e = np.exp(logits - m)
        return e / e.sum(axis=0, keepdims=True)

    Q = softmax(-U)
    for _ in range(n_iters):
        msg = norm * _filter2d_separable(norm * Q, k1d)
        # Potts: tmp1 = -U - (-compat * msg)
        Q = softmax(-U + compat * msg)
    return np.ascontiguousarray(Q.transpose(1, 2, 0).astype(np.float32))
