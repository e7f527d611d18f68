"""A cell's data: its configuration file, its traffic file and its limits,
found by the names in ``BENCHMARK.json``.

Every configuration, traffic mix, per-layer metric and limit sits in a file
of its own under ``bench/``, named after it, so a later cell needs new files
and new entries only:

- ``bench/configs/<config>.json``: the model as run (published key names,
  the layers this stage holds; under ``"port"`` the program's settings that
  the publication names otherwise or not at all);
- ``bench/traffic/<mix>.json``: the stages carried, the NDB mode, the
  batch, the token law, the step's hyper-parameters;
- ``bench/limits/<cell>.json``: the limit of each number the check
  compares;
- ``bench/metrics/<metric>.py``: a per-layer metric's reader.

Imports nothing of the program.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List

ROOT = os.path.dirname(os.path.abspath(__file__))

# published key names of each size, the first found wins
KEYS = {
    "d": ("hidden_size",),
    "stage_layers": ("num_hidden_layers", "num_layers"),
    "heads": ("num_attention_heads",),
    "kv_heads": ("num_key_value_heads", "multi_query_group_num"),
    "head_dim": ("head_dim", "kv_channels"),
    "d_ff": ("intermediate_size", "ffn_hidden_size"),
    "vocab": ("vocab_size", "padded_vocab_size"),
    "experts": ("num_experts",),
    "top_k": ("num_experts_per_tok",),
    "expert_d_ff": ("moe_intermediate_size",),
    "norm_eps": ("rms_norm_eps", "layernorm_epsilon"),
    "aux_loss_weight": ("router_aux_loss_coef",),
}


def _get(cfg: Dict, key: str):
    for k in KEYS[key]:
        if k in cfg:
            return cfg[k]
    return cfg.get("port", {}).get(key)


def read_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    config: Dict
    traffic: Dict
    limits: Dict
    chips: int

    @property
    def sizes(self) -> Dict:
        """The sizes the weights, the reference and the FLOP counts read."""
        c, t = self.config, self.traffic
        port = c["port"]
        m = {"d": _get(c, "d"), "heads": _get(c, "heads"), "kv_heads": _get(c, "kv_heads"),
             "head_dim": _get(c, "head_dim") or _get(c, "d") // _get(c, "heads"),
             "d_ff": _get(c, "d_ff") or 0, "vocab": _get(c, "vocab"),
             "layers": _get(c, "stage_layers") * int(t["stages_carried"]),
             "qk_norm": bool(port["qk_norm"]), "norm_eps": float(_get(c, "norm_eps")),
             "rope_theta": float(c.get("rope_theta", port.get("rope_theta"))),
             "dtype": c["torch_dtype"], "rank": int(t["mecefo"]["rank"]), "moe": None}
        if _get(c, "experts"):
            m["moe"] = {"experts": _get(c, "experts"), "top_k": _get(c, "top_k"),
                        "d_ff": _get(c, "expert_d_ff"),
                        "capacity_factor": float(port["capacity_factor"]),
                        "aux_loss_weight": float(_get(c, "aux_loss_weight"))}
        return m

    @property
    def batch(self) -> int:
        return int(self.traffic["batch"])

    @property
    def seq_len(self) -> int:
        return int(self.traffic["seq_len"])

    @property
    def tokens_per_step(self) -> int:
        return self.batch * self.seq_len


def load_benchmark(root: str) -> Dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def load_cell(root: str, name: str, bench_dir: str = ROOT, calibrate: bool = False) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with its files
    read from ``bench_dir``.  A cell without a limits file raises, unless
    ``calibrate`` (reading the numbers its limits are to be set from)."""
    bm = load_benchmark(root)
    entry = next((w for w in bm["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bm["configs"] if c["name"] == entry["config"])
    config = read_json(os.path.join(root, conf["file"]))
    traffic = read_json(os.path.join(bench_dir, "traffic", f"{entry['traffic']}.json"))
    lim_path = os.path.join(bench_dir, "limits", f"{name}.json")
    if os.path.exists(lim_path):
        limits = read_json(lim_path)
    elif calibrate:
        limits = {}
    else:
        raise FileNotFoundError(f"{name}: no limits file {lim_path}")
    return Cell(name, entry["config"], entry["traffic"], config, traffic, limits,
                int(entry["chips"]))


def cell_metrics(root: str, name: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` entries that cell ``name``
    reports: those without ``workloads``, and those that list it."""
    return [e for e in load_benchmark(root)[kind]
            if "workloads" not in e or name in e["workloads"]]
