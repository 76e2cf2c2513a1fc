"""PyTorch/CUDA port of the hhrs_tpu hotel recommender.

The JAX package ``hhrs_tpu`` is the reference; this package mirrors its
module names (``config``, ``data``, ``models``, ``ops``, ``retrieval``,
``serve``, ``train``) so each part has an obvious counterpart. It imports
``torch`` and never JAX, flax, pandas, msgpack or ``hhrs_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The one hand-written kernel of the serving path, the fused eval-mode DCN-R
tower, lives in ``csrc/tower_eval.cu`` and is bound in ``ops/tower.py``.
"""
