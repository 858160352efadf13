"""videoquery — a content-based video similarity search framework on the GPU.

A ground-up JAX/XLA rebuild of the capabilities of
PARC-projects/video-query-algorithms (see SURVEY.md for the blueprint):

- ``videoquery.pipeline``  — fused two-stream (RGB + warped TV-L1 optical flow)
  feature extraction with batched BN-Inception (TSN) ensembles.
- ``videoquery.nn``        — BN-Inception / TSN models in pure JAX.
- ``videoquery.kernels``   — warped TV-L1 optical flow and camera-motion fits.
- ``videoquery.index``     — sharded [N, 1024] embedding store, CSV-compatible
  with the reference feature format (calcSig_wOF.py:116-134).
- ``videoquery.search``    — target estimation, ensemble similarity + scoring,
  hyperparameter optimization, match selection (the math of
  src/models/{ticket,target_clip,hyperparameter}.py as batched array programs).
- ``videoquery.service``   — broker job loop, API client (coreapi-compatible
  action surface), DB loader, final reports.
- ``videoquery.train``     — TSN fine-tuning (data/ensemble-parallel over a mesh).
"""

__version__ = "0.1.0"
