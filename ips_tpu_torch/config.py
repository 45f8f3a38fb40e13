"""Typed configuration (copy of ips_tpu/config.py for the port).

Same schema, field names and validation as ``ips_tpu.config``, so the
shipped YAML files load unchanged. ``pyyaml`` is imported only when a
YAML file or a CLI override is parsed: the port itself runs without it.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

@dataclasses.dataclass
class TaskConfig:
    """One prediction task (reference config/mnist_config.yml:51-71)."""

    id: int
    name: str
    act_fn: str  # 'softmax' | 'sigmoid'
    metric: str  # 'accuracy' | 'multilabel_accuracy' | 'auc'

    def __post_init__(self):
        if self.act_fn not in ("softmax", "sigmoid"):
            raise ValueError(f"task {self.name}: unknown act_fn {self.act_fn!r}")
        if self.metric not in ("accuracy", "multilabel_accuracy", "auc"):
            raise ValueError(f"task {self.name}: unknown metric {self.metric!r}")


def _as_tuple2(v) -> Optional[Tuple[int, int]]:
    if v is None:
        return None
    return (int(v[0]), int(v[1]))


@dataclasses.dataclass
class Config:
    # --- opt (reference config/*_config.yml "#opt") ---
    n_epoch: int = 1
    B: int = 16            # optimizer batch size
    B_seq: int = 16        # loader batch size (B for eager/lazy, 1 for sequential)
    n_epoch_warmup: float = 10
    lr: float = 1e-3
    wd: float = 0.1

    # --- dset ---
    n_class: int = 10
    data_dir: str = ""
    train_fname: str = ""   # camelyon only
    test_fname: str = ""    # camelyon only
    n_worker: int = 0
    pin_memory: bool = True    # accepted for YAML compatibility
    eager: bool = True         # eager: whole patch tensor to HBM; lazy: stream chunks

    # --- misc ---
    eps: float = 1e-6
    seed: int = 0
    track_efficiency: bool = False
    track_epoch: int = 0

    # --- enc ---
    is_image: bool = True
    enc_type: str = "resnet18"      # 'resnet18' | 'resnet50'
    pretrained: bool = False
    n_chan_in: int = 1
    n_res_blocks: int = 2           # 2 or 4 truncation of the ResNet

    # --- ips ---
    shuffle: bool = True
    shuffle_style: str = "batch"    # 'batch' | 'instance'
    n_token: int = 1
    N: int = 0                      # total patches per image (0 => variable-N dataset)
    M: int = 100                    # memory (top-M buffer) size
    I: int = 100                    # iteration (chunk) size
    patch_size: Optional[Tuple[int, int]] = None
    patch_stride: Optional[Tuple[int, int]] = None

    # --- aggr ---
    use_pos: bool = False
    H: int = 8
    D: int = 128
    D_k: int = 16
    D_v: int = 16
    D_inner: int = 512
    attn_dropout: float = 0.1
    dropout: float = 0.1

    # --- tasks ---
    tasks: Dict[str, TaskConfig] = dataclasses.field(default_factory=dict)

    # ===== ips_tpu extensions (not in the reference schema; all defaulted) =====
    compute_dtype: str = "float32"     # 'float32' | 'bfloat16' encoder/attn compute
    input_dtype: str = "float32"       # patch storage dtype on device
    s2d_stem: bool = False             # accepted; the port runs the plain 7x7/2 stem
    sparse_input: bool = False         # training loader ships sparse pixels
    select_dtype: str = "default"      # 'default' | 'int8' selection encoder
    preencode_select: Any = "auto"     # True | False | 'auto' (> 96 MiB table)
    steps_per_dispatch: int = 1        # training: optimizer steps per dispatch
    stream_chunk_group: int = 4        # streaming selection: chunks per group
    ln_fold: bool = False              # feature projector LayerNorm->GEMM fold
    eval_reuse_emb: bool = True        # inference reuses the selection buffer's embeddings
    remat_encode: bool = False         # training: recompute the encoder in backward
    grad_encode_chunk: int = 0         # training: chunked gradient re-encode
    select_unroll: int = 1             # accepted; the port's loop is not unrolled
    score_impl: str = "fast"           # 'attn' | 'fast' | 'pallas' (the CUDA kernel on the card for both of the last two)
    use_pallas: bool = False           # back-compat alias for score_impl='pallas'
    mesh_data: int = 1                 # data-parallel mesh axis size
    mesh_patch: int = 1                # context/patch-parallel mesh axis size
    cp_select: str = "exact"           # context-parallel selection mode
    donate_buffers: bool = True        # accepted for compatibility
    checkpoint_dir: str = ""           # checkpoint dir ('' disables)
    checkpoint_every: int = 0          # epochs between checkpoints (0 disables)
    resume: bool = False               # resume from latest checkpoint
    bucket_sizes: Optional[List[int]] = None  # padding buckets for variable-N data
    mask_padding: bool = False         # mask padded patches in the final aggregation
    log_every: int = 0                 # steps between stdout loss logs (0 disables)
    pretrained_path: str = ""          # local .npz with converted pretrained weights
    profile_dir: str = ""              # profiler trace dir ('' disables)
    metrics_path: str = ""             # append per-epoch metrics as JSON lines
    input_norm: str = "none"           # 'imagenet': normalize inputs on device
    img_size: Optional[List[int]] = None  # dataset resize (H, W) override
    max_shift: Optional[int] = None    # traffic train-time translate bound (px)
    multihost: bool = False            # one process of a multi-host run
    coordinator_address: str = ""      # host:port of process 0 ('' = auto)
    num_processes: int = 0             # total processes (0 = auto)
    process_id: int = -1               # this process's id (-1 = auto)
    cpu_collectives: str = ""          # 'gloo' | 'mpi' cross-process collectives
    prefetch_depth: int = 2            # loader batches kept in flight on device

    def __post_init__(self):
        self.patch_size = _as_tuple2(self.patch_size)
        self.patch_stride = _as_tuple2(self.patch_stride)
        if self.enc_type not in ("resnet18", "resnet50"):
            raise ValueError(f"unknown enc_type {self.enc_type!r}")
        if self.n_res_blocks not in (2, 4):
            raise ValueError("n_res_blocks must be 2 or 4")
        if self.shuffle_style not in ("batch", "instance"):
            raise ValueError(f"unknown shuffle_style {self.shuffle_style!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.input_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown input_dtype {self.input_dtype!r}")
        if self.sparse_input and not self.eager:
            raise ValueError("sparse_input implies eager (on-device) patches")
        if self.use_pallas:
            self.score_impl = "pallas"
        if self.score_impl not in ("attn", "fast", "pallas"):
            raise ValueError(f"unknown score_impl {self.score_impl!r}")
        if self.input_norm not in ("none", "imagenet"):
            raise ValueError(f"unknown input_norm {self.input_norm!r}")
        if self.input_norm == "imagenet" and (not self.is_image
                                              or self.n_chan_in != 3):
            raise ValueError("input_norm='imagenet' needs RGB image input")
        if self.prefetch_depth < 1:
            raise ValueError("prefetch_depth must be >= 1")
        if self.select_unroll < 1:
            raise ValueError("select_unroll must be >= 1")
        if self.cp_select not in ("exact", "local_merge"):
            raise ValueError(
                f"cp_select must be 'exact' or 'local_merge', got "
                f"{self.cp_select!r}")
        if (self.select_unroll > 1 and self.mesh_patch > 1
                and self.cp_select == "local_merge"):
            raise ValueError(
                "select_unroll > 1 is not supported with "
                "cp_select='local_merge': that path runs per-shard scans "
                "and would silently ignore the knob")
        if self.select_unroll > 1 and not self.eager:
            raise ValueError(
                "select_unroll > 1 needs eager=true: streaming (lazy) "
                "selection is host-chunked and would silently ignore the "
                "knob")
        if self.steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if self.grad_encode_chunk < 0:
            raise ValueError("grad_encode_chunk must be >= 0 (0 disables)")
        if self.stream_chunk_group < 1:
            raise ValueError("stream_chunk_group must be >= 1")
        if self.use_pos and self.N <= 0:
            raise ValueError(
                "use_pos needs a fixed patch count (N > 0): the positional "
                "table is built per original patch index (reference "
                "ips_net.py:110-113); variable-N datasets (N=0) must set "
                "use_pos: false")
        if self.preencode_select not in (True, False, "auto"):
            raise ValueError(
                f"preencode_select must be true/false/'auto', got "
                f"{self.preencode_select!r}")
        if (self.preencode_select is True and self.mesh_patch > 1
                and self.cp_select == "local_merge"):
            raise ValueError(
                "preencode_select=true is not supported with "
                "cp_select='local_merge': that path streams per-shard "
                "chunks and would silently ignore the knob (leave it "
                "'auto', which stays off there; cp_select='exact' "
                "supports pre-encoding)")
        if self.img_size is not None:
            self.img_size = _as_tuple2(self.img_size)
        if self.max_shift is not None and self.max_shift < 0:
            raise ValueError("max_shift must be >= 0")
        if self.cpu_collectives not in ("", "gloo", "mpi"):
            raise ValueError(
                f"unknown cpu_collectives {self.cpu_collectives!r}")
        if self.select_dtype not in ("default", "int8"):
            raise ValueError(f"unknown select_dtype {self.select_dtype!r}")
        if self.select_dtype == "int8" and not self.is_image:
            raise ValueError(
                "select_dtype=int8 quantizes the conv encoder; feature "
                "mode (is_image=false) uses the projector — leave default")
        if self.M <= 0 or self.I <= 0:
            raise ValueError("M and I must be positive")
        if self.B % self.B_seq != 0:
            # Same contract as the reference: B_seq is either B (eager/lazy)
            # or 1 (eager sequential) — see reference config/*.yml "#opt".
            raise ValueError("B must be a multiple of B_seq")
        if self.D % 2 != 0 and self.use_pos:
            raise ValueError("use_pos requires even D (sin/cos interleave)")
        if isinstance(self.tasks, dict):
            fixed = {}
            for k, v in self.tasks.items():
                fixed[k] = v if isinstance(v, TaskConfig) else TaskConfig(**v)
            self.tasks = fixed
        if not self.tasks:
            raise ValueError("config must define at least one task")
        n_tok_needed = len(self.tasks)
        if self.n_token < n_tok_needed:
            raise ValueError(
                f"n_token={self.n_token} < number of tasks ({n_tok_needed})")

    # -- convenience --------------------------------------------------------
    @property
    def task_list(self) -> List[TaskConfig]:
        return sorted(self.tasks.values(), key=lambda t: t.id)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return d

    def pretty(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


_FIELD_NAMES = {f.name for f in dataclasses.fields(Config)}


def config_from_dict(d: Dict[str, Any]) -> Config:
    unknown = set(d) - _FIELD_NAMES
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return Config(**d)


def _parse_override(val: str) -> Any:
    """Parse a CLI override value with YAML scalar rules."""
    import yaml
    return yaml.safe_load(val)


def load_config(path: str, overrides: Optional[List[str]] = None) -> Config:
    """Load a YAML (or JSON) config with optional key=value overrides."""
    with open(path, "r") as f:
        if path.endswith(".json"):
            d = json.load(f)
        else:
            import yaml
            d = yaml.safe_load(f)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        k, v = ov.split("=", 1)
        d[k.strip()] = _parse_override(v)
    return config_from_dict(d)
