"""Mean detections a demo request keeps after DensePose's NMS, of the
R-CNN's 100 static slots: the program's counter ``densepose.detections``
over the window, over the window's requests. The NMS walk
(``ops/nms.py::nms_topk``) stops at its 100th kept box, so a request that
fills every slot ends its walk early and one that keeps fewer walks every
candidate: the count says which. The painting no longer depends on it
(it paints the last detection alone)."""


def read(cell, res):
    n = res.get("detections")
    if n is None or not res["done"]:
        return None
    return n / len(res["done"])
