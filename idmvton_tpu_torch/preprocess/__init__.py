"""Preprocessing front-end: OpenPose, SCHP parsing, DensePose, the agnostic
mask (counterpart of ``idmvton_tpu/preprocess``)."""
