"""Request ids drawn from the seed: the pool a window reuses in turn.

The id law is a frozen copy of the zipf branch of
``repro_torch.data.synthetic.sample_ids``: a bounded zipf law per field,
P(id = r) proportional to (r + 1)^-s for r < n, by inverse CDF of the
continuous bounded power law, in float64. The uniforms come from a
``torch.Generator`` on the device, in a few large calls, so a pool of
millions of rows takes a fraction of a second; the same seed gives the
same pool on the same kind of device.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["sub_seed", "zipf_pool", "global_rows"]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``--seed``: any
    whole number, negative or past 64 bits included."""
    words = [ord(c) for c in tag]
    seq = np.random.SeedSequence([abs(int(seed)) % (1 << 64),
                                  int(seed < 0), *words])
    return int(seq.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def zipf_pool(field_sizes, rows: int, exponent: float, seed: int,
              device: torch.device, chunk: int = 1 << 18) -> np.ndarray:
    """(rows, k) int32 ids, field i in [0, field_sizes[i]), on the host."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "ids"))
    n = torch.tensor(field_sizes, dtype=torch.float64, device=device)[None]
    s = float(exponent)
    out = torch.empty((rows, n.shape[1]), dtype=torch.int32, device=device)
    for lo in range(0, rows, chunk):
        hi = min(rows, lo + chunk)
        u = torch.rand((hi - lo, n.shape[1]), dtype=torch.float64,
                       generator=gen, device=device)
        if abs(s - 1.0) < 1e-9:
            x = torch.pow(n, u)
        else:
            x = torch.pow(1.0 + u * (torch.pow(n, 1.0 - s) - 1.0),
                          1.0 / (1.0 - s))
        ids = torch.floor(x) - 1.0
        out[lo:hi] = torch.minimum(torch.clamp_min(ids, 0.0), n - 1.0).to(
            torch.int32)
    return out.cpu().numpy()


def global_rows(ids: np.ndarray, field_sizes) -> np.ndarray:
    """The mega-table row of every id: ids plus the field's offset."""
    offsets = np.concatenate([[0], np.cumsum(field_sizes)[:-1]])
    return ids.astype(np.int64) + offsets[None, :]
