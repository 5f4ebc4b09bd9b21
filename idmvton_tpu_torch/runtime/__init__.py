"""Host runtime: the C++ ROIAlign oracle, NMS and COCO evaluator
(counterpart of ``idmvton_tpu/runtime``)."""
