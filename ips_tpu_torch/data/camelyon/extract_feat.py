"""Offline step 3 of 3: slide tiles through an encoder -> per-slide
features (counterpart of ips_tpu/data/camelyon/extract_feat.py).

The foreground tiles of each slide (``tile_size`` px at level ``lvl``,
center-cropped to 224) are encoded in batches by an eval-mode ResNet-50
with all four stages (2048-d, bf16 compute), its weights drawn from
seed 0 or loaded from a converted ``.npz`` (``--pretrained_path``, see
``ips_tpu_torch.models.pretrained``).

The feed: each uint8 batch is copied into pinned host memory and sent
``non_blocking``, normalized on the card as ``x.float() / 255``, the tail
batch padded to the one batch shape; the features come back through a
pinned buffer. Dispatch is asynchronous, one batch deep: the host reads
the next batch while the card encodes this one.

Output (:func:`extract_features`): an HDF5 file with one group per
slide, datasets ``img`` (N, 2048) fp32 and ``pos`` (N,) int64 and the
group attribute ``label``, gzip-compressed by a writer thread, whose
error is raised again on the calling thread; the file the JAX package
writes. :func:`extract_slide_features` returns the same three fields per
slide for slides held in memory (no h5py or pandas needed).

    python -m ips_tpu_torch.data.camelyon.extract_feat [--tile_size 256] \\
        [--batch_size 64] [--pretrained_path w.npz] [--device cpu] \\
        data_dir otsu_fname bounds_pkl coords_pkl feat_save_path
"""

from __future__ import annotations

import argparse
import queue
import threading
from typing import (Callable, Dict, Iterable, Iterator, Mapping, Optional,
                    Tuple, Union)

import numpy as np
import torch

from ips_tpu_torch.data.camelyon.slide import Slide
from ips_tpu_torch.models.encoders import ConvPatchEncoder, encoder_out_dim
from ips_tpu_torch.models.ips_net import init_weights
from ips_tpu_torch.utils.device import resolve_device

TILE_CROP = 224          # center crop of the 256-px tile
SlideFeatures = Dict[str, Union[np.ndarray, int]]


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    y0 = max(0, (h - size) // 2)
    x0 = max(0, (w - size) // 2)
    return img[y0:y0 + size, x0:x0 + size]


class _SyncEncoder:
    """Adapt a plain callable ``(B, H, W, 3) float in [0,1] -> (B, D)``
    to the dispatch/fetch API (eager: no overlap)."""

    def __init__(self, fn: Callable[[np.ndarray], np.ndarray]):
        self._fn = fn

    def dispatch(self, tiles_u8: np.ndarray):
        return self._fn(tiles_u8.astype(np.float32) / 255.0)

    def fetch(self, handle) -> np.ndarray:
        return np.asarray(handle)


class PipelinedEncoder:
    """Eval-mode ResNet encoder with an asynchronous dispatch/fetch API.

    ``dispatch`` takes a (n <= batch_size, h, w, 3) uint8 batch and
    returns a handle at once; ``fetch`` waits for its (n, D) fp32
    features. Two pinned input and output buffers alternate, so one batch
    can be in flight while the host prepares the next. On the CPU
    (``device='cpu'``) both run the same forward synchronously.
    """

    def __init__(self, enc_type: str = "resnet50", pretrained_path: str = "",
                 batch_size: int = 64, device=None):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.dim = encoder_out_dim(enc_type, 4)
        with torch.random.fork_rng(devices=[]):
            model = ConvPatchEncoder(enc_type, 3, 4, dtype=torch.bfloat16)
        init_weights(model, torch.Generator().manual_seed(0))
        if pretrained_path:
            from ips_tpu_torch.models.pretrained import load_encoder_npz
            load_encoder_npz(pretrained_path, model)
        self.model = model.to(self.device).eval()
        self._slot = 0
        self._pinned = None       # (inputs, outputs, input-copy events)

    def _forward(self, x_u8: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(x_u8.float() / 255.0)

    def _buffers(self, tile_shape):
        if self._pinned is None or self._pinned[0][0].shape[1:] != tile_shape:
            b = self.batch_size
            self._pinned = (
                [torch.empty((b,) + tile_shape, dtype=torch.uint8,
                             pin_memory=True) for _ in range(2)],
                [torch.empty((b, self.dim), pin_memory=True)
                 for _ in range(2)],
                [None, None])
        return self._pinned

    def dispatch(self, tiles_u8: np.ndarray):
        n = tiles_u8.shape[0]
        if n > self.batch_size:
            raise ValueError(f"batch of {n} tiles > batch_size "
                             f"{self.batch_size}")
        if self.device.type != "cuda":
            x = torch.zeros((self.batch_size,) + tiles_u8.shape[1:],
                            dtype=torch.uint8)
            x[:n] = torch.from_numpy(np.ascontiguousarray(tiles_u8))
            return self._forward(x)[:n].numpy()
        ins, outs, copied = self._buffers(tuple(tiles_u8.shape[1:]))
        slot, self._slot = self._slot, self._slot ^ 1
        if copied[slot] is not None:     # its last copy to the card is done
            copied[slot].synchronize()
        buf = ins[slot]
        buf[:n] = torch.from_numpy(np.ascontiguousarray(tiles_u8))
        buf[n:] = 0                       # one shape for the tail batch
        x = buf.to(self.device, non_blocking=True)
        copied[slot] = torch.cuda.Event()
        copied[slot].record()
        outs[slot].copy_(self._forward(x), non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return slot, done, n

    def fetch(self, handle) -> np.ndarray:
        if isinstance(handle, np.ndarray):
            return handle
        slot, done, n = handle
        done.synchronize()
        return self._pinned[1][slot][:n].numpy().copy()

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        """Synchronous: a float [0,1] or uint8 batch -> features."""
        if batch.dtype != np.uint8:
            batch = np.clip(batch * 255.0 + 0.5, 0, 255).astype(np.uint8)
        return self.fetch(self.dispatch(batch))


def _as_pipeline(encoder):
    return encoder if hasattr(encoder, "dispatch") else _SyncEncoder(encoder)


def encode_slides(items: Iterable[Tuple[str, Slide, np.ndarray, np.ndarray]],
                  encoder, *, lvl: int = 0, tile_size: int = 256,
                  batch_size: int = 64
                  ) -> Iterator[Tuple[str, int, np.ndarray, np.ndarray]]:
    """(name, slide, (n, 2) level-0 xy, (n,) pos) per slide -> (name,
    label, (n, D) features, pos), one batch in flight: the host reads
    batch k + 1 while the encoder runs batch k."""
    y0 = max(0, (tile_size - TILE_CROP) // 2)
    for name, slide, xy, pos in items:
        feats, pending = [], None
        for s in range(0, len(xy), batch_size):
            tiles = slide.read_tiles(xy[s:s + batch_size], lvl,
                                     (tile_size, tile_size))
            handle = encoder.dispatch(
                tiles[:, y0:y0 + TILE_CROP, y0:y0 + TILE_CROP])
            if pending is not None:
                feats.append(encoder.fetch(pending))
            pending = handle
        if pending is not None:
            feats.append(encoder.fetch(pending))
        slide.close()
        features = (np.concatenate(feats, axis=0) if feats
                    else np.zeros((0, 2048), np.float32))
        yield name, int(slide.has_tumor), features, pos


def extract_slide_features(slides: Mapping[str, Slide],
                           coords: Mapping[str, np.ndarray],
                           bounds: Mapping[str, np.ndarray], *,
                           lvl: int = 0, tile_size: int = 256,
                           batch_size: int = 64, encoder=None
                           ) -> Dict[str, SlideFeatures]:
    """Features of slides held in memory, from the foreground tables as
    :func:`..foreground.foreground_tables` returns them: ``{name: {"img":
    (N, D) fp32, "pos": (N,) int64, "label": int}}`` in bounds order."""
    enc = _as_pipeline(encoder or PipelinedEncoder(batch_size=batch_size))
    xy_all = np.stack([coords["x"], coords["y"]], axis=1)

    def items():
        for name, s, e in zip(bounds["name"], bounds["start_id"],
                              bounds["end_id"]):
            yield (str(name), slides[str(name)], xy_all[s:e + 1],
                   np.asarray(coords["pos_id"][s:e + 1], np.int64))
    return {name: {"img": f, "pos": pos, "label": label}
            for name, label, f, pos in encode_slides(
                items(), enc, lvl=lvl, tile_size=tile_size,
                batch_size=batch_size)}


def extract_features(data_dir: str, otsu_fname: str, bounds_pkl: str,
                     coords_pkl: str, feat_save_path: str, *,
                     lvl: int = 0, tile_size: int = 256,
                     batch_size: int = 64,
                     encoder: Optional[Callable] = None) -> str:
    import h5py
    import pandas as pd

    from ips_tpu_torch.data.camelyon.slide import SlideManager

    bounds = pd.read_pickle(bounds_pkl)
    coords = pd.read_pickle(coords_pkl)
    slide_man = SlideManager(data_dir=data_dir, otsu_fname=otsu_fname)
    enc = _as_pipeline(encoder or PipelinedEncoder(batch_size=batch_size))

    # Writer thread: gzip compression of finished slides overlaps the next
    # slide's encode. The bounded queue caps the features held; on a
    # writer error the queue is drained so that the producer never
    # blocks, and the error is raised again on this thread.
    wq: "queue.Queue" = queue.Queue(maxsize=2)
    werr: list = []

    def _writer():
        try:
            with h5py.File(feat_save_path, "w") as h5:
                n_done = 0
                while True:
                    item = wq.get()
                    if item is None:
                        return
                    name, label, feats_np, pos_np = item
                    grp = h5.create_group(name)
                    grp.create_dataset("img", data=feats_np,
                                       compression="gzip",
                                       compression_opts=9)
                    grp.create_dataset("pos", data=pos_np,
                                       compression="gzip",
                                       compression_opts=9)
                    grp.attrs["label"] = label
                    n_done += 1
                    print("Nr. slides processed: ", n_done, flush=True)
        except Exception as e:  # noqa: BLE001 - raised on the caller
            werr.append(e)
            while wq.get() is not None:
                pass

    def items():
        for row in bounds.itertuples():
            rows = coords.iloc[row.start_id:row.end_id + 1]
            yield (row.name, slide_man.get_slide(row.name),
                   rows[["x", "y"]].to_numpy(),
                   rows["pos_id"].to_numpy().astype(np.int64))

    wt = threading.Thread(target=_writer, daemon=True)
    wt.start()
    try:
        for item in encode_slides(items(), enc, lvl=lvl,
                                  tile_size=tile_size,
                                  batch_size=batch_size):
            if werr:
                break
            wq.put(item)
    finally:
        wq.put(None)
        wt.join()
    if werr:
        raise werr[0]
    print("Stored features successfully!")
    return feat_save_path


def main(argv=None):
    from ips_tpu_torch.utils.device import fp32_matmuls
    fp32_matmuls()
    p = argparse.ArgumentParser(
        description="Extract tile features into per-slide HDF5 groups")
    p.add_argument("--lvl", type=int, default=0)
    p.add_argument("--tile_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--pretrained_path", default="",
                   help="local .npz with converted encoder weights")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' to run there)")
    p.add_argument("data_dir")
    p.add_argument("otsu_fname")
    p.add_argument("bounds_pkl")
    p.add_argument("coords_pkl")
    p.add_argument("feat_save_path")
    a = p.parse_args(argv)
    enc = PipelinedEncoder(pretrained_path=a.pretrained_path,
                           batch_size=a.batch_size, device=a.device)
    extract_features(a.data_dir, a.otsu_fname, a.bounds_pkl, a.coords_pkl,
                     a.feat_save_path, lvl=a.lvl, tile_size=a.tile_size,
                     batch_size=a.batch_size, encoder=enc)


if __name__ == "__main__":
    main()
