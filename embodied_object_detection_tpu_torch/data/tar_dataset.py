"""Tar-file ImageNet-21k dataset (the weak-supervision co-training input).

Counterpart of the JAX package's `data/tar_dataset.py` (ref: Detic/detic/
data/tar_dataset.py:1-137): one tar per synset, read through a numpy
memmap with a 512-byte-block offset index ({basename}_names.npy /
{basename}_offsets.npy); gzip-wrapped JPEGs are unwrapped, and an image
that does not decode becomes a gray 224x224 placeholder with label -1.
`build_tar_index` writes the index from a tar, and a member's payload is
found by walking its header sequence (PAX extended headers and GNU long
names skipped) and sliced to the size its real header gives. PIL is
imported where an image is decoded.
"""

from __future__ import annotations

import gzip
import io
import os
import tarfile
from typing import List, Tuple

import numpy as np

BLOCK = 512

# tar header meta typeflags that precede the real file header:
# 'x' pax per-file / 'g' pax global extended header, 'L'/'K' GNU long
# name/link records. Each is one header block + size payload blocks.
_META_TYPEFLAGS = (b"x", b"g", b"L", b"K")


def _header_size(header: bytes) -> int:
    """Member size from a tar header: octal, or GNU base-256 when the
    leading bit of the size field is set."""
    field = header[124:136]
    if field[0] & 0x80:
        return int.from_bytes(bytes([field[0] & 0x7F]) + field[1:], "big")
    text = field.split(b"\0")[0].strip()
    return int(text, 8) if text else 0


def tar_member_payload(data) -> bytes:
    """Exact file payload of one tar member whose header sequence starts at
    data[0] (a uint8 array/bytes spanning at least through the payload).

    Skips pax/GNU meta records, then slices the true size from the real
    header — no trailing block padding, no garbage from treating a pax
    extended header as the payload."""
    pos = 0
    while True:
        header = bytes(data[pos:pos + BLOCK])
        if len(header) < BLOCK or header[0] == 0:
            raise ValueError("truncated or empty tar member header")
        size = _header_size(header)
        if header[156:157] in _META_TYPEFLAGS:
            pos += BLOCK * (1 + (size + BLOCK - 1) // BLOCK)
            continue
        start = pos + BLOCK
        if start + size > len(data):
            raise ValueError("tar member payload extends past index slice")
        return bytes(data[start:start + size])


def build_tar_index(tar_path: str, out_dir: str) -> Tuple[str, str]:
    """Write {basename}_names.npy / {basename}_offsets.npy for a tar file.

    offsets[i] is the 512-byte block index of member i's HEADER; a final
    sentinel offset marks the end so sizes are offsets[i+1]-offsets[i]
    (the reference's layout, tar_dataset.py:110-124)."""
    names: List[str] = []
    offsets: List[int] = []
    with open(tar_path, "rb") as f, tarfile.open(fileobj=f) as tf:
        for member in tf:
            if not member.isfile():
                continue
            names.append(member.name)
            offsets.append(member.offset // BLOCK)
        end = tf.offset // BLOCK
    offsets.append(end)
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(tar_path))[0]
    names_path = os.path.join(out_dir, f"{base}_names.npy")
    offsets_path = os.path.join(out_dir, f"{base}_offsets.npy")
    np.save(names_path, np.asarray(names))
    np.save(offsets_path, np.asarray(offsets, np.int64))
    return names_path, offsets_path


class _TarDataset:
    """memmap-backed member access for one tar (ref: tar_dataset.py:88-137)."""

    def __init__(self, filename: str, npy_index_dir: str, preload: bool = False):
        self.filename = filename
        self.npy_index_dir = npy_index_dir
        names, offsets = self.load_index()
        self.num_samples = len(names)
        self.offsets = offsets
        self.data = np.memmap(filename, mode="r", dtype="uint8") \
            if preload else None

    def load_index(self):
        base = os.path.splitext(os.path.basename(self.filename))[0]
        names = np.load(os.path.join(self.npy_index_dir, f"{base}_names.npy"))
        offsets = np.load(os.path.join(self.npy_index_dir,
                                       f"{base}_offsets.npy"))
        return names, offsets

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx: int) -> io.BytesIO:
        if self.data is None:
            self.data = np.memmap(self.filename, mode="r", dtype="uint8")
        ofs = int(self.offsets[idx]) * BLOCK
        fsize = BLOCK * int(self.offsets[idx + 1] - self.offsets[idx])
        data = tar_member_payload(self.data[ofs: ofs + fsize])
        # a few ImageNet JPEGs are gzip-compressed
        if data[:2] == b"\x1f\x8b":
            return io.BytesIO(gzip.decompress(data))
        return io.BytesIO(data)


class DiskTarDataset:
    """Concatenation of per-synset tar datasets; the label of a sample is
    the index of the tar (synset) it came from (ref: tar_dataset.py:18-86)."""

    def __init__(self, tarfile_path: str, tar_index_dir: str,
                 preload: bool = False, num_synsets="all"):
        tar_files = np.load(tarfile_path)
        if isinstance(num_synsets, int):
            assert num_synsets < len(tar_files)
            tar_files = tar_files[:num_synsets]
        self.chunk_datasets = [
            _TarDataset(str(t), tar_index_dir, preload=preload)
            for t in tar_files]
        self.dataset_lens = np.asarray(
            [len(d) for d in self.chunk_datasets], np.int32)
        self.dataset_cumsums = np.cumsum(self.dataset_lens)
        self.num_samples = int(self.dataset_lens.sum())

    def __len__(self):
        return self.num_samples

    def __getitem__(self, index: int):
        """-> (PIL image RGB, synset label or -1 on decode failure, index)."""
        from PIL import Image
        assert 0 <= index < len(self)
        # side='right' handles boundary indices AND duplicate cumsums from
        # empty tars (e.g. lens [3,0,2] -> cumsums [3,3,5]: index 3 must
        # route to dataset 2, not the empty dataset 1)
        d_index = int(np.searchsorted(self.dataset_cumsums, index,
                                      side="right"))
        local = index if d_index == 0 \
            else index - int(self.dataset_cumsums[d_index - 1])
        data = self.chunk_datasets[d_index][local]
        try:
            image = Image.open(data).convert("RGB")
        except Exception:
            image = Image.fromarray(
                np.full((224, 224, 3), 128, np.uint8))
            d_index = -1
        return image, d_index, index

    def __repr__(self):
        return (f"DiskTarDataset(subdatasets={len(self.dataset_lens)},"
                f"samples={self.num_samples})")
