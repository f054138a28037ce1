"""Seeded audio made on the device: brown-noise sources (white noise summed
over time, so that most energy sits low, as in speech) under a slow random
envelope, and standardized two-source mixtures of them.

``highpass_hz`` takes out what lies below it, as a recording's DC and
rumble are: with it, a chunk of a few seconds has a mean near 0, as speech
has, and the separated sources differ by more than their shared offset.
"""

from __future__ import annotations


def brown_sources(torch, n: int, length: int, gen, device, highpass_bins: int = 0):
    """(n, length) fp32 sources, zero mean and unit variance a row, each
    under a smooth envelope of 8 random levels between 0.2 and 1; the
    lowest ``highpass_bins`` bins of each row's spectrum are zeroed before
    the envelope."""
    x = torch.randn((n, length), generator=gen, device=device).cumsum(dim=-1)
    x = x - torch.linspace(0, 1, length, device=device) * x[:, -1:]  # end where it began
    if highpass_bins:
        spec = torch.fft.rfft(x, dim=-1)
        spec[:, :highpass_bins] = 0
        x = torch.fft.irfft(spec, n=length, dim=-1)
    env = 0.2 + 0.8 * torch.rand((n, 1, 8), generator=gen, device=device)
    env = torch.nn.functional.interpolate(env, size=length, mode="linear",
                                          align_corners=True)[:, 0]
    x = x * env
    x = x - x.mean(dim=-1, keepdim=True)
    return x / (x.std(dim=-1, keepdim=True) + 1e-8)


def mixtures(torch, n: int, length: int, gen, device, n_sources: int = 2,
             highpass_hz: float = 0.0, fs: int = 8000):
    """(n, length) standardized sums of ``n_sources`` brown sources at gains
    within +-2.5 dB of each other, with nothing below ``highpass_hz``."""
    bins = int(round(highpass_hz * length / fs))
    src = brown_sources(torch, n * n_sources, length, gen, device, bins)
    src = src.view(n, n_sources, length)
    gain_db = (torch.rand((n, n_sources, 1), generator=gen, device=device) - 0.5) * 5.0
    mix = (src * 10.0 ** (gain_db / 20.0)).sum(dim=1)
    mix = mix - mix.mean(dim=-1, keepdim=True)
    return mix / (mix.std(dim=-1, keepdim=True) + 1e-8)
