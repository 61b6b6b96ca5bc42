"""Host -> device batch transfer (counterpart of mafed_tpu/data/prefetch.py).

On a CUDA device, DevicePrefetcher keeps `depth` batches in flight: each
batch's arrays are staged in pinned host memory and copied on a side stream
while the card runs the current step. Before a batch is handed over, the
consumer stream waits for the event recorded after that batch's copies, and
every copied tensor is marked as used by the consumer stream
(`record_stream`), so the caching allocator does not hand its memory to the
copy stream again while the step may still read it. On the CPU the arrays
become tensors in place.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, Iterator, Union

import numpy as np
import torch

DEVICE_KEYS = ("input_ids", "attention_mask", "labels", "pixels", "patches", "patch_idx", "t_hs", "t_idx")


def as_tensor(x) -> torch.Tensor:
    """numpy arrays -> tensors sharing their memory; tensors pass through."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def to_device(batch: Dict, device: torch.device, non_blocking: bool = True) -> Dict:
    """The batch's arrays as tensors on `device`, on the current stream (from
    pinned memory, without a host sync, on CUDA); other fields as they are."""
    out = {}
    for k, v in batch.items():
        if k in DEVICE_KEYS:
            t = as_tensor(v)
            out[k] = t.pin_memory().to(device, non_blocking=non_blocking) if device.type == "cuda" else t.to(device)
        else:
            out[k] = v
    return out


class DevicePrefetcher:
    def __init__(self, iterable: Iterable[Dict], device: Union[str, torch.device], depth: int = 2) -> None:
        self.iterable = iterable
        self.device = torch.device(device)
        self.depth = max(1, depth)
        self._stream = None

    def _put(self, batch: Dict):
        if self.device.type != "cuda":
            return to_device(batch, self.device), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            out = to_device(batch, self.device)
            done = torch.cuda.Event()
            done.record(self._stream)
        return out, done

    def _hand_over(self, out: Dict, done) -> Dict:
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for k in DEVICE_KEYS:
                if k in out:
                    out[k].record_stream(consumer)
        return out

    def __iter__(self) -> Iterator[Dict]:
        it = iter(self.iterable)
        try:
            buf = collections.deque()
            for batch in it:
                buf.append(self._put(batch))
                if len(buf) >= self.depth:
                    break
            while buf:
                out = buf.popleft()
                nxt = next(it, None)
                if nxt is not None:
                    buf.append(self._put(nxt))
                yield self._hand_over(*out)
        finally:
            # stop the loader's producer thread when the stream is abandoned
            close = getattr(it, "close", None)
            if close:
                close()
