"""Configuration of the PyTorch port.

A field-for-field copy of `nann_tpu/config.py` (`ModelConfig`, `TrainConfig`,
`SearchConfig`, `default_frontier_cap`, `IndexConfig`, `PathConfig`,
`Config`), kept separate so the port imports nothing of the JAX package.
The field names, order and defaults are the export-bundle contract:
`model_config.json` and the `search_config` entry of `signature.json` are
`dataclasses.asdict` of these classes, and both packages load each other's
bundles with `Config(**json)`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence


def _makedirs(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


@dataclasses.dataclass
class ModelConfig:
    """Scorer architecture (nann_tpu/config.py:22-48)."""

    num_item: int = 1000
    num_cate: int = 100
    emb_dim: int = 32                 # id/cate embedding dim; item emb dim = 2*emb_dim
    max_seq_length: int = 50
    item_tower_dims: Sequence[int] = (64, 64, 64)
    head_dims: Sequence[int] = (128, 64, 32, 1)      # final layer bias-free
    # attention projections: d -> att_proj_mult1*d -> att_proj_mult2*d
    att_proj_mult1: int = 2
    att_proj_mult2: int = 4
    bn_momentum: float = 0.99
    bn_epsilon: float = 1e-3
    # compute dtype of the scorer products ("bfloat16" to serve, "float32" in tests)
    compute_dtype: str = "float32"

    @property
    def item_emb_dim(self) -> int:
        return 2 * self.emb_dim

    @property
    def user_emb_dim(self) -> int:
        return 2 * self.emb_dim


@dataclasses.dataclass
class TrainConfig:
    """Training hyperparameters (nann_tpu/config.py:49-83), with the same
    defaults; see there for the reasons behind the schedule options."""

    batch_size: int = 800
    train_epochs: int = 5
    learning_rate: float = 3e-3
    # "constant" or "cosine" (decay to learning_rate * lr_final_ratio over
    # the step budget); warmup applies to either
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    lr_final_ratio: float = 0.01
    # cosine decay horizon; 0 = the loop's total step budget
    lr_total_steps: int = 0
    weight_decay: float = 1e-4
    adv_eps: float = 3e-5             # FGSM epsilon; 0 disables
    adv_weight: float = 1.0
    num_neg: int = 200                # negatives per positive
    save_freq: int = 5000
    print_freq: int = 50
    max_to_keep: int = 50             # checkpoint retention
    seed: int = 0
    # data-parallel shards of the train step: the CLI trains on a world of
    # dp ranks (train/loop.py, main.py)
    dp: int = 1


def default_frontier_cap(num_items: int) -> int:
    """Catalogue-aware frontier capacity (nann_tpu/config.py:75-85): 4096 up to
    about 2M items, 8192 above, where a smaller cap truncates ground hops."""
    return 4096 if num_items <= 2_000_000 else 8192


@dataclasses.dataclass
class SearchConfig:
    """HNSW search budget (nann_tpu/config.py:88-200). Index 0 = ground level.

    See the JAX package for the meaning of each option; the port runs every
    one of them (search/beam.py).
    """

    hnsw_start_level: int = 2
    num_scoring_per_level: Sequence[int] = (3, 1, 1)   # ground..start
    top_k_per_level: Sequence[int] = (400, 200, 100)   # ground..start
    topk_eval: Sequence[int] = (200,)
    semantics: str = "eval"
    frontier_cap: int = 4096
    frontier_cap_per_hop: Optional[Sequence[int]] = None
    topk_impl: str = "exact"
    hop_mode: str = "filtered"
    vis_impl: str = "list"
    mark_policy: str = "scored"

    def validate(self) -> None:
        if len(self.num_scoring_per_level) != self.hnsw_start_level + 1:
            raise ValueError("num_scoring_per_level needs one entry per level")
        if len(self.top_k_per_level) != self.hnsw_start_level + 1:
            raise ValueError("top_k_per_level needs one entry per level")
        if self.num_scoring_per_level[self.hnsw_start_level] != 1:
            raise ValueError("the start level scores its enter points once")
        choices = {"semantics": ("eval", "serving"),
                   "topk_impl": ("exact", "approx", "topk"),
                   "hop_mode": ("filtered", "wide"),
                   "vis_impl": ("bytemap", "list"),
                   "mark_policy": ("all", "scored")}
        for name, allowed in choices.items():
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name}={getattr(self, name)!r} not in {allowed}")
        if self.frontier_cap_per_hop is not None:
            hops = sum(self.num_scoring_per_level[:self.hnsw_start_level])
            if len(self.frontier_cap_per_hop) != hops:
                raise ValueError(
                    f"frontier_cap_per_hop needs one entry per expansion hop "
                    f"({hops}), got {len(self.frontier_cap_per_hop)}")

    def hop_cap(self, hop_index: int) -> int:
        """Frontier capacity of the hop_index-th expansion hop (0-based, in
        search order; nann_tpu/config.py:187-192)."""
        if self.frontier_cap_per_hop is not None:
            return int(self.frontier_cap_per_hop[hop_index])
        return self.frontier_cap


@dataclasses.dataclass
class IndexConfig:
    """HNSW build parameters (nann_tpu/config.py:195-201)."""

    num_neighbors: int = 32           # M; ground level stores up to 2M
    ef_construction: int = 200
    seed: int = 42


@dataclasses.dataclass
class PathConfig:
    """The output layout under one root (nann_tpu/config.py:204-218): model/,
    embeddings/, index/ and export/, made when the config is."""

    output_root: str = "./output"
    dataset_dir: str = "./data"

    def __post_init__(self):
        self.model_save_dir = _makedirs(os.path.join(self.output_root, "model"))
        emb_dir = _makedirs(os.path.join(self.output_root, "embeddings"))
        self.item_ids_file = os.path.join(emb_dir, "item_ids.npy")
        self.item_embs_file = os.path.join(emb_dir, "item_embs.npy")
        self.index_dir = _makedirs(os.path.join(self.output_root, "index"))
        self.export_dir = _makedirs(os.path.join(self.output_root, "export"))
        self.log_file = os.path.join(self.output_root, "nann_tpu.log")


@dataclasses.dataclass
class Config:
    """Every config of a run (nann_tpu/config.py:221-241)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    index: IndexConfig = dataclasses.field(default_factory=IndexConfig)
    paths: Optional[PathConfig] = None
    num_test_users: int = 10000

    @staticmethod
    def from_dataset_meta(meta_path: str, **overrides) -> "Config":
        """A Config with the catalogue sizes of the converter's
        `ub_meta.json` (nann_tpu/config.py:228-241)."""
        with open(meta_path) as f:
            meta = json.load(f)
        cfg = Config(**overrides)
        cfg.model.num_item = meta["num_item"]
        cfg.model.num_cate = meta["num_cate"]
        cfg.model.max_seq_length = meta["max_length"]
        cfg.num_train_samples = meta.get("num_train_samples", 0)
        return cfg
