"""Join smoothing for the vocoder (magphase) resynthesis path, in PyTorch.

Counterpart of ``snickery_tpu/features/smoothing.py``: for a trajectory
(F, d) made of units of ``frames_per_unit`` frames, each join at frame b
blends the frames in [b - width, b + width) toward the straight line between
the two units' edge frames.
"""

from __future__ import annotations

import torch

from snickery_tpu_torch.features.stft import as_f32


def smooth_joins(traj, frames_per_unit: int, width: int = 2, strength=1.0,
                 device="cuda") -> torch.Tensor:
    """Crossfade-smooth the trajectory around every unit boundary, on
    ``device``.

    Within ``width`` frames of a join each frame is pulled toward the
    linear interpolation between the last pre-join and first post-join
    frames; ``strength`` in [0, 1] scales the effect.  Frames further from
    any join are untouched; unit interiors and the utterance's edges are
    kept exactly for ``width <= frames_per_unit // 2``."""
    traj = as_f32(traj, device)
    F = traj.shape[0]
    k = frames_per_unit
    if F < 2 * k or width < 1:
        return traj
    idx = torch.arange(F, device=traj.device)
    # position of each frame relative to the nearest join: < 2 * width is near one
    phase = (idx + width) % k
    join = ((idx + width) // k) * k
    active = (phase < 2 * width) & (join >= k) & (join < F)
    left = torch.clamp(join - 1, 0, F - 1)
    right = torch.clamp(join, 0, F - 1)
    alpha = torch.clamp((idx - (join - width) + 0.5) / (2.0 * width), 0.0, 1.0)
    target = (1.0 - alpha)[:, None] * traj[left] + alpha[:, None] * traj[right]
    # the blend weight peaks at the join and falls to 0 at the window's edges
    dist = torch.minimum(phase, 2 * width - 1 - phase)
    w = torch.where(active, (dist + 1.0) / (width + 0.0) / 2.0, 0.0)
    w = torch.clamp(w * torch.as_tensor(strength, dtype=torch.float32, device=traj.device),
                    0.0, 1.0)[:, None]
    return traj * (1.0 - w) + target * w
