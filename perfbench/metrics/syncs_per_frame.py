"""CUDA host syncs (cudaStreamSynchronize, cudaDeviceSynchronize,
cudaEventSynchronize, blocking cudaMemcpy) made inside the fused entry's
`yondx.frame` spans, per frame (spans.py)."""


def read(r):
    if not r.get("span_frames"):
        return None
    return sum(v for k, v in r["span_syncs"].items()
               if k != "between frames") / r["span_frames"]
