"""Image and file IO: PFM, 8-bit PNG, CSV and JSON.

Counterpart of ``wcmc_tpu/utils/img_utils.py``.  PFM is a 3-line header
and raw floats stored bottom-up.  PNG is written and read here with
``zlib`` and ``struct`` (8-bit grey, grey + alpha, RGB or RGBA,
non-interlaced), so no imaging package is needed; ``write_img`` /
``read_img`` take PFM for ``.pfm`` paths and PNG otherwise.  The debug
viewers import matplotlib when called.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np


# ---------------------------------------------------------------------------
# PFM (portable float map)
# ---------------------------------------------------------------------------

def write_pfm(path: str, img: np.ndarray, scale: float = 1.0):
    """Write an (H, W) or (H, W, 3) float32 image as PFM (bottom-up)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 3 and img.shape[2] == 3:
        header = b"PF\n"
    elif img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 1):
        header = b"Pf\n"
        img = img.reshape(img.shape[0], img.shape[1])
    else:
        raise ValueError(f"PFM supports 1 or 3 channels, got {img.shape}")
    h, w = img.shape[:2]
    endian = -scale if np.little_endian else scale
    with open(path, "wb") as f:
        f.write(header)
        f.write(f"{w} {h}\n".encode())
        f.write(f"{endian}\n".encode())
        f.write(np.flipud(img).tobytes())


def read_pfm(path: str) -> tuple[np.ndarray, float]:
    """Read a PFM file -> (image (H, W[, 3]) float32, scale)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().rstrip())
        data = np.frombuffer(f.read(), dtype="<f4" if scale < 0 else ">f4",
                             count=h * w * channels)
    img = data.reshape(h, w, channels) if channels == 3 else data.reshape(h, w)
    return np.flipud(img).astype(np.float32), abs(scale)


# ---------------------------------------------------------------------------
# 8-bit PNG
# ---------------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_COLOR = {1: 0, 2: 4, 3: 2, 4: 6}     # channels -> PNG colour type
_PNG_CHANNELS = {v: k for k, v in _PNG_COLOR.items()}


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray):
    """Write an (H, W) or (H, W, C) uint8 image, C in 1..4, as PNG."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[2] not in _PNG_COLOR:
        raise ValueError(f"PNG takes 1 to 4 channels, got {arr.shape}")
    h, w, c = arr.shape
    # filter type 0 (none) in front of every row
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR[c], 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = raw[y, 0]
        line = raw[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                elif ftype == 4:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                else:
                    raise ValueError(f"bad PNG filter type {ftype}")
                cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit non-interlaced PNG (grey, grey + alpha, RGB or RGBA)
    -> (H, W) or (H, W, C) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace or color not in _PNG_CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey/RGB(A) PNGs are read")
    c = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w * c + 1)
    img = _unfilter(raw, h, w * c, c).reshape(h, w, c)
    return img[..., 0] if c == 1 else img


# ---------------------------------------------------------------------------
# Generic image IO
# ---------------------------------------------------------------------------

def write_img(path: str, img: np.ndarray):
    """PFM for .pfm paths, 8-bit PNG otherwise (floats clipped to [0, 1]
    and scaled by 255, as the reference writes them)."""
    if path.lower().endswith(".pfm"):
        write_pfm(path, img)
        return
    arr = np.asarray(img)
    if arr.dtype in (np.float32, np.float64):
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    write_png(path, arr)


def read_img(path: str) -> np.ndarray:
    if path.lower().endswith(".pfm"):
        return read_pfm(path)[0]
    return read_png(path)


# ---------------------------------------------------------------------------
# Tabular / structured dumps
# ---------------------------------------------------------------------------

def write_csv(path: str, rows, header=None):
    with open(path, "w") as f:
        if header:
            f.write(",".join(str(h) for h in header) + "\n")
        for row in rows:
            f.write(",".join(str(x) for x in row) + "\n")


def write_json(path: str, obj):
    def default(o):
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
        raise TypeError(type(o))

    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=default)


# ---------------------------------------------------------------------------
# Debug viewers (file-backed: training hosts are headless)
# ---------------------------------------------------------------------------

def im_show(img: np.ndarray, title: str = "img", save_to: str | None = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.imshow(np.clip(img, 0, 1) if img.dtype.kind == "f" else img)
    ax.set_title(title)
    if save_to:
        fig.savefig(save_to)
    plt.close(fig)


def plot_histogram(values: np.ndarray, bins: int = 100, title: str = "hist",
                   save_to: str | None = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    ax.hist(np.ravel(values), bins=bins)
    ax.set_title(title)
    if save_to:
        fig.savefig(save_to)
    plt.close(fig)


# reference-style aliases
WriteImg = write_img
ReadImg = read_img
WriteCSV = write_csv
WriteJson = write_json
ImShow = im_show
MatShow = im_show
PlotHistogram = plot_histogram
