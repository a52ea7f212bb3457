"""Cold-load an export bundle for serving (nann_tpu/delivery/verify_export.py:
`load_serving_bundle`)."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import SearchConfig
from ..index import load_index
from ..search.beam import SearchIndex
from ..utils import resolve_device
from .export import load_exported, load_search_config


def load_serving_bundle(export_dir: str, scfg: SearchConfig = None,
                        max_degree=None, dtype=None, device="cuda"):
    """Export bundle -> (params, state, mcfg, SearchIndex) on `device`.

    scfg defaults to the bundle's own SearchConfig; the item table is
    bfloat16 when the model computes in bfloat16, else float32, unless
    `dtype` says otherwise: "int8" packs it as int8 values and a float32
    scale per row (SearchIndex.from_artifacts)."""
    dev = resolve_device(device)
    scfg = scfg or load_search_config(export_dir)
    params, state, mcfg = load_exported(export_dir, device=dev)
    item_ids = np.load(os.path.join(export_dir, "item_ids.npy"))
    item_embs = np.load(os.path.join(export_dir, "item_embs.npy")).astype(
        np.float32)
    art = load_index(os.path.join(export_dir, "index"), scfg.hnsw_start_level,
                     max_degree=max_degree)
    if dtype is None:
        dtype = torch.bfloat16 if mcfg.compute_dtype == "bfloat16" else \
            torch.float32
    index = SearchIndex.from_artifacts(art, item_embs, item_ids, dtype=dtype,
                                       device=dev)
    return params, state, mcfg, index
