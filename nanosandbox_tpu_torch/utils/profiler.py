"""A torch.profiler window: start it, stop it into a Chrome trace.

Shared by the trainer's ``profile_steps`` window (train.py) and the
serving engine's on-demand ``POST /profile`` window (serve/engine.py):
CPU activity always, CUDA activity (CUPTI) on a CUDA device. torch is
imported inside the functions, so importing this module costs nothing.
"""

from __future__ import annotations

import os

# Short kernels launched right after a CUDA trace opens: a trace can lose
# its first records (a trace of one decode chunk lacked the chunk's first
# ~40 kernels), and these take their place.
PREAMBLE_KERNELS = 512


def start(device, preamble: bool = False):
    """A started torch.profiler.profile over ``device`` (a torch.device).
    ``preamble`` launches PREAMBLE_KERNELS short kernels first on CUDA."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.start()
    if cuda and preamble:
        for _ in range(PREAMBLE_KERNELS):
            torch.cuda._sleep(1)
    return profiler


def stop(profiler, device, path: str) -> str:
    """Drain the device so the window holds its work (the sync ledger's
    'profile-window-drain'), stop the profiler and write its Chrome trace
    to ``path`` (directories created). Returns the path."""
    import torch

    from nanosandbox_tpu_torch.utils import tracecheck

    tracecheck.host_sync("profile-window-drain")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    profiler.export_chrome_trace(path)
    return path
