"""The reference's collective bytes beside the port's bytes between
positions, for reduced llama3-8b ``train_4k`` and ``decode_32k`` on a
(2, 4) ("data", "model") mesh.

The reference: its ``Cell.lower()`` on a (2, 4) mesh of host devices,
compiled, and ``parse_hlo``'s ``collective_bytes`` by HLO kind (each
collective's result shape on one device, times its loop trips) and
``collective_count``. The port: ``Cell.lower()`` on a meta (2, 4) mesh
(the split step, one batch row traced), the busiest position's bytes
sent plus received by kind, and each kind's mean over the 8 positions.

Run from the repo root (the script sets
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` before JAX loads):

    PYTHONPATH=src python build/ref_collectives.py
"""

import contextlib
import importlib
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import repro.configs as JC  # noqa: E402
import repro_torch.configs as TC  # noqa: E402
from repro.analysis.hlo_parse import parse_hlo  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.distributed import make_mesh  # noqa: E402
from repro_torch.distributed.tensor_parallel import KINDS  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402

CELLS = (("train_4k", 16, 8), ("decode_32k", 64, 8))


@contextlib.contextmanager
def patched(arch, shape, seq, batch):
    mods = [importlib.import_module(f"{p.__name__}.{p._ARCH_MODULES[arch]}")
            for p in (JC, TC)]
    saved = [m.CONFIG for m in mods]
    shapes = [dict(p.SHAPES) for p in (JC, TC)]
    try:
        for m in mods:
            m.CONFIG = m.CONFIG.reduced()
        for p in (JC, TC):
            p.SHAPES[shape] = p.ShapeCell(shape, seq, batch,
                                          p.SHAPES[shape].kind)
        yield
    finally:
        for m, c in zip(mods, saved):
            m.CONFIG = c
        for p, old in zip((JC, TC), shapes):
            p.SHAPES.clear()
            p.SHAPES.update(old)


def main():
    out = {}
    for shape, seq, batch in CELLS:
        with patched("llama3-8b", shape, seq, batch):
            jcell = jsteps.build_cell("llama3-8b", shape, make_test_mesh(2, 4))
            lowered, _ = jcell.lower()
            st = parse_hlo(lowered.compile().as_text())
            cell = build_cell("llama3-8b", shape,
                              make_mesh((2, 4), ("data", "model"), "meta"))
        low, _ = cell.lower()
        mean = {k: sum(n for (kk, _), n in low.moved.items() if kk == k) / 8
                for k in KINDS}
        out[shape] = {
            "reference_bytes": {k: v for k, v in st.collective_bytes.items()
                                if v},
            "reference_count": {k: v for k, v in st.collective_count.items()
                                if v},
            "port_policy": cell.policy, "port_rows": low.rows,
            "port_busiest": low.moved_by_kind,
            "port_busiest_total": low.moved_bytes,
            "port_mean": {k: v for k, v in mean.items() if v},
            "cfg": {"d": cell.cfg.d_model, "f": cell.cfg.d_ff,
                    "L": cell.cfg.n_layers, "vocab": cell.cfg.vocab,
                    "heads": cell.cfg.n_heads, "kv": cell.cfg.n_kv_heads,
                    "hd": cell.cfg.hd, "dtype": cell.cfg.dtype},
        }
    json.dump(out, sys.stdout, indent=1)
    print()


if __name__ == "__main__":
    main()
