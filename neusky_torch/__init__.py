"""neusky_torch — the PyTorch / CUDA (Hopper) port of ``neusky_tpu``.

The package mirrors the JAX package's layout (``core/``, ``ops/``,
``nets/``, ``fields/``, ``sampling/``, ``shading/``, ``models/``,
``engine/``, ``data/``, ``configs/``) so every module has a counterpart a
reader can find by name.  It imports ``torch`` and numpy only; the JAX
package is the reference it is tested against, never a dependency.

Conventions:

- parameters are nested dicts of tensors keyed exactly like the flax
  parameter trees (``convert.py`` turns a flat ``{flax_path: array}`` dict
  into them); dense kernels stay ``[in, out]`` and hash tables ``[L, F, T]``;
- every function that draws randomness takes an optional explicit draw, so
  tests can feed it the JAX package's draws (the two random streams never
  match);
- entry points take ``device`` and default to ``"cuda"``; they raise when
  CUDA is absent unless the caller passes ``device="cpu"``;
- the one TPU kernel of the JAX package (the hash-table gradient scatter)
  is a hand-written CUDA kernel for ``sm_90a`` (``csrc/``), bound with
  ctypes and built with ``nvcc`` at first use.
"""

__version__ = "0.1.0"
