"""Full-frame tiled inference dataset (numpy, host side).

Copy of ``wcmc_tpu/data/full_image.py``: loads a full frame's caches at
an arbitrary spp (concatenating extra-sample part caches), tiles it into
128 x 128 patches, and keeps per-tile interior-crop coordinates so the
assembled output equals an untiled run over the valid region.  Also
exposes the ``has_hit`` mask (first-bounce type != 0) used for
background/emitter passthrough.  Tiles are views of the padded frame;
``evaluate.inference`` stacks them into batches.
"""

from __future__ import annotations

import os

import numpy as np

from wcmc_tpu_torch.data import schema
from wcmc_tpu_torch.data.dataset import _cache_name

PATCH_SIZE = schema.PATCH_SIZE
PAD_SIZE = 32                     # covers the 28 px KPCN shrink


class FullImageDataset:
    def __init__(
        self,
        in_fn: str,
        spp: int,
        base_model: str = "sbmc",
        use_g_buf: bool = True,
        use_sbmc_buf: bool = True,
        use_llpm_buf: bool = False,
        pnet_out_size: int = 3,
        feat_imp: bool = False,
        seed: int = 0,
        tile_h: int | None = None,
        tile_w: int | None = None,
        stride: int | None = None,
    ):
        """``tile_h``/``tile_w``/``stride`` select the device tiling.

        Defaults: 128 x 128 tiles; stride 72 for KPCN (the tile's FULL
        72-px VALID output is used, so assembly still equals the
        untiled forward exactly — reference support/datasets.py:1277
        strides 64 and discards 8 px/side of computed output, ~27%
        extra conv work), stride 64 for the sample-space models (SAME
        convs: the extra interior margin hides boundary effects, so
        the reference's 64 is behavior-relevant there).

        Any tile size that fits device memory is legal (the gather
        kernel takes any frame size).  Tile dims must be multiples of 4
        (the PathNet UNet pools 2 levels).
        """
        if base_model not in ("kpcn", "sbmc", "lbmc"):
            raise RuntimeError(f"Unknown baseline model {base_model}")
        if os.sep + "input" + os.sep not in in_fn:
            raise ValueError(f"{in_fn} is not under an 'input' directory")
        if base_model == "lbmc":
            base_model, use_sbmc_buf, use_g_buf = "sbmc", False, True

        self.in_fn = in_fn
        self.gt_fn = in_fn.replace(
            os.sep + "input" + os.sep, os.sep + "gt" + os.sep
        )
        self.spp = spp
        self.base_model = base_model
        self.use_g_buf = use_g_buf
        self.use_sbmc_buf = use_sbmc_buf
        self.use_llpm_buf = use_llpm_buf
        self.channels = schema.ChannelConfig(
            base_model, use_g_buf=use_g_buf, use_sbmc_buf=use_sbmc_buf,
            use_llpm_buf=use_llpm_buf, pnet_out_size=pnet_out_size,
        )

        sample = self._load_full_buffer()
        if feat_imp and use_llpm_buf:
            # feature-importance permutation test: shuffle path
            # descriptors across (pixel, sample) positions
            p = sample["paths"]
            h, w, s, c = p.shape
            flat = p.reshape(-1, c)
            perm = np.random.default_rng(seed).permutation(flat.shape[0])
            sample["paths"] = flat[perm].reshape(h, w, s, c)

        if base_model == "kpcn":
            h, w, _ = sample["target_total"].shape
            self.full_ipt = (
                sample["kpcn_diffuse_buffer"] * sample["kpcn_albedo"]
                + np.expm1(sample["kpcn_specular_buffer"])
            )
            self.full_tgt = sample["target_total"]
        else:
            h, w = sample["radiance"].shape[:2]
            self.full_ipt = sample["radiance"].mean(axis=2)
            self.full_tgt = sample["target_image"]
        self.has_hit = np.repeat(self.has_hit, 3, axis=-1)

        # Auto-pad to the tile grid: the stride decomposition needs
        # (H - 2*pad) % stride == 0 (the reference asserts instead,
        # datasets.py:1278, which rejects e.g. 1920x1080 frames).
        # Replicate-pad on the bottom/right; evaluate.inference crops
        # the canvas back to (orig_h, orig_w).
        self.tile_h = th = tile_h or PATCH_SIZE
        self.tile_w = tw = tile_w or PATCH_SIZE
        assert th % 4 == 0 and tw % 4 == 0, (th, tw)
        # per-side interior margin; must cover the model's half-shrink
        # (28 for KPCN d9/k21 — its full VALID output is then used)
        if stride is not None:
            pad = (th - stride) // 2
        else:
            pad = 28 if base_model == "kpcn" else PAD_SIZE
        assert 0 < pad <= PAD_SIZE, (stride, pad)
        self.pad_h = self.pad_w = pad
        pad_h = pad_w = pad
        stride_h, stride_w = th - 2 * pad, tw - 2 * pad
        self.orig_h, self.orig_w = h, w

        def _padded(n, tile, pad, stride):
            n_eff = max(n, tile)
            rem = (n_eff - 2 * pad) % stride
            return n_eff + (stride - rem) % stride

        ph = _padded(h, th, pad_h, stride_h)
        pw = _padded(w, tw, pad_w, stride_w)
        if (ph, pw) != (h, w):
            def pad_hw(arr, h_axis):
                pad = [(0, 0)] * arr.ndim
                pad[h_axis] = (0, ph - h)
                pad[h_axis + 1] = (0, pw - w)
                return np.pad(arr, pad, mode="edge")

            sample = {k: pad_hw(v, 0) for k, v in sample.items()}
            self.full_ipt = pad_hw(self.full_ipt, 0)
            self.full_tgt = pad_hw(self.full_tgt, 0)
            self.has_hit = pad_hw(self.has_hit, 0)
            h, w = ph, pw
        self.h, self.w = h, w

        # model layout: sample-space -> (S, H, W, C)
        for k, v in sample.items():
            if v.ndim == 4:
                sample[k] = np.transpose(v, (2, 0, 1, 3))

        self.samples, self.coords = [], []
        for i in range(0, h - 2 * pad_h, stride_h):
            for j in range(0, w - 2 * pad_w, stride_w):
                i_start = 0 if i == 0 else i + pad_h
                j_start = 0 if j == 0 else j + pad_w
                i_end = i + th if i == h - th else i + th - pad_h
                j_end = j + tw if j == w - tw else j + tw - pad_w
                self.coords.append((i_start, j_start, i_end, j_end, i, j))
                self.samples.append({
                    k: v[..., i:i + th, j:j + tw, :]
                    for k, v in sample.items()
                })

    def _load_full_buffer(self) -> dict:
        in_fn = self.in_fn
        sample = {}
        if self.base_model == "sbmc":
            s_buf = self._load_parts(_cache_name(in_fn, "sbmc_s"))
            sample["radiance"] = s_buf[..., 0:3]
            feats = s_buf[..., 3:27] if self.use_g_buf else s_buf[..., 3:6]
            if self.use_sbmc_buf:
                p_buf = self._load_parts(_cache_name(in_fn, "sbmc_p"))
                feats = np.concatenate([feats, p_buf], axis=-1)
            sample["features"] = feats
        else:
            buf = np.load(_cache_name(in_fn, f"kpcn_{self.spp}"))
            sample["kpcn_diffuse_in"] = np.concatenate(
                [buf[..., :10], buf[..., 20:]], axis=-1
            )
            sample["kpcn_specular_in"] = buf[..., 10:]
            sample["kpcn_diffuse_buffer"] = buf[..., 0:3]
            sample["kpcn_specular_buffer"] = buf[..., 10:13]
            sample["kpcn_albedo"] = buf[..., 34:37] + schema.ALBEDO_EPS

        llpm = self._load_parts(_cache_name(in_fn, "llpm"))
        if self.use_llpm_buf:
            pw = llpm[..., :1]
            if self.base_model == "sbmc":
                sample["features"] = np.concatenate(
                    [sample["features"], pw], axis=-1
                )
            else:
                sample["kpcn_diffuse_in"] = np.concatenate(
                    [sample["kpcn_diffuse_in"], pw.mean(axis=2)], axis=-1
                )
                sample["kpcn_specular_in"] = np.concatenate(
                    [sample["kpcn_specular_in"], pw.mean(axis=2)], axis=-1
                )
            sample["paths"] = llpm[..., 1:]

        gt = np.load(self.gt_fn).astype(np.float32)
        if self.base_model == "sbmc":
            sample["target_image"] = gt[..., 0:3]
        else:
            total, diffuse, albedo = gt[..., 0:3], gt[..., 3:6], gt[..., 6:9]
            sample["target_diffuse"] = diffuse / (albedo + schema.ALBEDO_EPS)
            sample["target_specular"] = np.log1p(np.maximum(total - diffuse, -0.9999))
            sample["target_total"] = total

        # first bounce type == 0 <=> eye ray hit background or emitter
        bt_col = 24  # bounce_types start inside the 36-ch 'paths' block
        self.has_hit = (
            llpm[..., 1:].mean(axis=2)[..., bt_col:bt_col + 1] != 0.0
        ).astype(np.float32)
        return sample

    def _load_parts(self, base_fn: str) -> np.ndarray:
        """Load a cached buffer, concatenating ``_1.._i`` part caches on
        the sample axis until spp is reached."""
        arr = np.asarray(np.load(base_fn, mmap_mode="r"))
        i = 0
        base, ext = os.path.splitext(base_fn)
        # cache part names: foo_llpm.npy -> foo_llpm_1.npy
        while arr.shape[2] < self.spp:
            i += 1
            part = f"{base}_{i}{ext}"
            arr = np.concatenate(
                [arr, np.asarray(np.load(part, mmap_mode="r"))], axis=2
            )
        return arr[:, :, :self.spp, :]

    def __len__(self):
        return len(self.coords)

    def __getitem__(self, idx: int):
        return self.samples[idx], self.coords[idx]
