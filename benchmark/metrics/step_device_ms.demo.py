"""Device milliseconds of one replayed batch-1 denoise step of a demo
request: the union of the device intervals of the kernels that the traced
request's ``cudaGraphLaunch`` calls ran, over the number of those launches
(the try-on's steps are the request's only graph launches)."""


def read(cell, res):
    tr = res["trace"]
    if tr is None or not tr.graph_launches:
        return None
    return 1e3 * tr.busy_s(graph_only=True) / tr.graph_launches
