"""CUDA launches (cudaLaunchKernel*, cuLaunchKernel*, cudaMemcpyAsync,
cudaMemsetAsync) made inside the fused entry's `yondx.frame` spans, per
frame (spans.py)."""


def read(r):
    if not r.get("span_frames"):
        return None
    return sum(v for k, v in r["span_launches"].items()
               if k != "between frames") / r["span_frames"]
