"""The device a run uses: the card (``cuda:0``) in every benchmark run; the
CPU only in the harness's own tests, which skip the look for a card."""
from __future__ import annotations

import torch


class _NoEvent:
    def record(self):
        pass

    def synchronize(self):
        pass


class Device:
    def __init__(self, kind="cuda"):
        self.is_cuda = kind == "cuda"
        self.torch = torch.device("cuda", 0) if self.is_cuda \
            else torch.device("cpu")

    def ctx(self, mxt):
        """The port's context for this device."""
        return mxt.gpu(0) if self.is_cuda else mxt.cpu()

    def sync(self):
        if self.is_cuda:
            torch.cuda.synchronize(self.torch)

    def event(self):
        """An event recorded on the current stream, to bound how far the
        host runs ahead of the device without reading anything back."""
        ev = torch.cuda.Event() if self.is_cuda else _NoEvent()
        ev.record()
        return ev

    def name(self):
        return torch.cuda.get_device_name(self.torch) if self.is_cuda \
            else "cpu"

    def peak_bytes(self):
        return int(torch.cuda.max_memory_allocated(self.torch)) \
            if self.is_cuda else 0

    def release(self):
        """Give cached memory back after the program's state is freed."""
        import gc
        gc.collect()
        if self.is_cuda:
            torch.cuda.empty_cache()


def check_cards(needed):
    """None when ``needed`` cards are visible, else the reason there are
    not."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < needed:
        return "the cell needs %d cards, torch.cuda.device_count() is %d" \
            % (needed, torch.cuda.device_count())
    return None
