"""Speech-like utterances made on the device from a seed: a frozen, batched
torch copy of ``snickery_tpu_torch.synthetic_voices.synth_utterance`` (the
generator of ``tests/toyvoice.py``), with its pitch marks.

The generator is split into its random draws and a deterministic renderer:
:func:`draw` takes the phones, the two f0 draws and one row of standard
normal noise a segment from a ``torch.Generator`` on the device, and
:func:`render` turns them into waves exactly as the source does (harmonic
stacks under gliding formants, fricative noise, stop gaps and bursts, the
moving f0, the peak normalisation), in float64, for many utterances at once.
Fed the draws of the source's own ``numpy`` generator, :func:`render`
returns the source's waves (held so by ``benchmark/tests/test_harness_data.py``).

Pitch marks are the generator's own: an epoch at each sample where the
glottal phase ``cumsum(f0) / SR`` passes a whole cycle (the source's voices
run its native epoch detector instead; see ``PERF.md``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

SR = 16000
N_HARM = 12
VOWELS = ["a", "e", "i", "o", "u", "ae", "ii", "uu", "oo", "er",
          "m", "n", "l", "r", "w"]
FRICS = ["s", "f", "sh", "z"]
STOPS = ["t", "k"]
PHONES = VOWELS + FRICS + STOPS
_FMT = {
    "a": ((2, 5), (2, 6)), "e": ((2, 7), (3, 7)), "i": ((1, 8), (1, 9)),
    "o": ((1, 4), (2, 4)), "u": ((1, 3), (1, 2)), "ae": ((3, 6), (2, 6)),
    "ii": ((1, 9), (2, 9)), "uu": ((1, 2), (1, 3)), "oo": ((2, 4), (1, 5)),
    "er": ((2, 5), (3, 4)), "m": ((1, 2), (1, 2)), "n": ((1, 3), (1, 3)),
    "l": ((2, 4), (2, 5)), "r": ((2, 3), (3, 3)), "w": ((1, 2), (2, 3)),
}
_DEPTH = {"s": 0.9, "f": 0.75, "sh": 0.8, "z": 0.55}


def seg_len(seg_sec: float = 0.15) -> int:
    return int(seg_sec * SR)


def draw(gen: torch.Generator, n_utts: int, n_segments: int, seg_sec: float = 0.15):
    """The random draws of ``n_utts`` utterances from ``gen`` (on its device):
    phones (n, S) int64, the f0 rate and phase draws (n, 2) in [0, 1), and
    noise (n, S, seg_len) float64."""
    dev = gen.device
    phones = torch.randint(0, len(PHONES), (n_utts, n_segments), generator=gen, device=dev)
    f0_draws = torch.rand((n_utts, 2), generator=gen, device=dev, dtype=torch.float64)
    noise = torch.randn((n_utts, n_segments, seg_len(seg_sec)), generator=gen, device=dev,
                        dtype=torch.float64)
    return phones, f0_draws, noise


def _tables(dev):
    """Per-phone-class columns: is stop, is fricative, is z, fricative
    depth, formant (start, end) harmonics."""
    n = len(PHONES)
    stop = torch.tensor([p in STOPS for p in PHONES], device=dev)
    fric = torch.tensor([p in FRICS for p in PHONES], device=dev)
    is_z = torch.tensor([p == "z" for p in PHONES], device=dev)
    depth = torch.tensor([_DEPTH.get(p, 0.0) for p in PHONES], dtype=torch.float64, device=dev)
    fmt = torch.zeros((n, 4), dtype=torch.float64, device=dev)
    for i, p in enumerate(PHONES):
        if p in _FMT:
            (a1, a2), (b1, b2) = _FMT[p]
            fmt[i] = torch.tensor([a1, a2, b1, b2], dtype=torch.float64)
    return stop, fric, is_z, depth, fmt


def glottal_cycles(f0_draws: torch.Tensor, n: int) -> torch.Tensor:
    """(n_utts, n) float64: the cumulated f0 over the sample rate, the
    glottal phase in cycles (``phase = 2 pi cycles``)."""
    dev = f0_draws.device
    t = torch.arange(n, dtype=torch.float64, device=dev) / SR
    rate = 0.4 + 0.2 * f0_draws[:, :1]
    f0 = 110.0 + 30.0 * torch.sin(2 * np.pi * rate * t[None, :] + f0_draws[:, 1:] * 6)
    return torch.cumsum(f0, dim=1) / SR


def render(phones: torch.Tensor, f0_draws: torch.Tensor, noise: torch.Tensor):
    """Waves (n_utts, S * seg_len) float32 and glottal cycles (float64) of
    the draws, as ``synth_utterance`` renders one utterance."""
    n_utts, S, L = noise.shape
    dev = noise.device
    n = S * L
    cycles = glottal_cycles(f0_draws, n)
    phase = (2 * np.pi * cycles).reshape(n_utts, S, L)
    stop, fric, is_z, depth, fmt = _tables(dev)
    st, fr, zz = (m[phones][:, :, None] for m in (stop, fric, is_z))
    u = torch.linspace(0.0, 1.0, L, dtype=torch.float64, device=dev)
    env = torch.minimum(torch.ones_like(u), u / 0.12) * (1.0 - 0.35 * u)

    # stops: closure silence, then a decaying burst of the segment's first
    # L - b0 noise samples, and a light voicing tail
    b0 = int(0.55 * L)
    j = torch.arange(L - b0, dtype=torch.float64, device=dev)
    stop_seg = torch.zeros_like(noise)
    stop_seg[:, :, b0:] = 0.5 * noise[:, :, : L - b0] * torch.exp(-j / (0.012 * SR))
    stop_seg = stop_seg + 0.08 * torch.sin(phase) * (u > 0.8)

    # fricatives: differenced noise (first sample 0), voicing for z
    diffed = torch.diff(noise, dim=2, prepend=noise[:, :, :1])
    fric_seg = depth[phones][:, :, None] * 0.35 * diffed
    fric_seg = (fric_seg + torch.where(zz, 0.25 * torch.sin(phase), 0.0)) * env

    # vowels and sonorants: two formant bumps over 12 harmonics, gliding
    f = fmt[phones]                                           # (n, S, 4)
    f1 = f[:, :, 0:1] + (f[:, :, 2:3] - f[:, :, 0:1]) * u
    f2 = f[:, :, 1:2] + (f[:, :, 3:4] - f[:, :, 1:2]) * u
    vowel_seg = torch.zeros_like(noise)
    for h in range(1, N_HARM + 1):
        bump = (0.6 * torch.exp(-0.5 * ((h - f1) / 1.0) ** 2)
                + 0.4 * torch.exp(-0.5 * ((h - f2) / 1.2) ** 2))
        vowel_seg += bump * (1.0 / math.sqrt(h)) * torch.sin(h * phase)
    vowel_seg = vowel_seg * env

    wave = torch.where(st, stop_seg, torch.where(fr, fric_seg, vowel_seg))
    wave = wave.reshape(n_utts, n)
    peak = torch.clamp(wave.abs().amax(dim=1, keepdim=True), min=1e-6)
    wave = wave * (0.9 / peak * 0.7)
    return wave.float(), cycles


def pitch_marks(cycles: torch.Tensor):
    """(utterance index, sample) int64 pairs of the samples at which the
    glottal phase passes a whole cycle, in utterance then sample order."""
    whole = torch.floor(cycles)
    mark = whole[:, 1:] > whole[:, :-1]
    utt, pos = torch.nonzero(mark, as_tuple=True)
    return utt, pos + 1
