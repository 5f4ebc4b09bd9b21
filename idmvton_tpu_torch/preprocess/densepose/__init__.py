"""DensePose R-50-FPN R-CNN (counterpart of
``idmvton_tpu/preprocess/densepose``)."""
