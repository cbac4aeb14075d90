"""Channel layouts of the raw OptaGen renderer dumps and derived buffers.

The renderer emits, per image, a float array of shape ``(H, W, S, 104)``
(``S`` = samples/pixel) plus a ground-truth array ``(H, W, 9)``.  The
channel index maps below mirror the reference's raw-feature ranges
(reference support/datasets.py:223-267) — they are renderer facts, not
code structure.

Derived cached buffers (written by the offline preprocessing pass):

====================  =======================  =============================
buffer                 shape                    channels
====================  =======================  =============================
``*_llpm.npy``         (H, W, S, 37)            LLPM path descriptor
``*_sbmc_s.npy``       (H, W, S, 27)            SBMC sample buffer
``*_sbmc_p.npy``       (H, W, S, 66)            SBMC path buffer
``*_kpcn_<spp>.npy``   (H, W, 44)               KPCN pixel statistics
``*_prob_imp.npy``     (H-128, W-128)           patch importance map
====================  =======================  =============================
"""

from __future__ import annotations

import dataclasses

MAX_DEPTH = 5
N_BOUNCES = MAX_DEPTH + 1          # 6 recorded bounces per path
RAW_CHANNELS = 104                 # per-sample channels in an OptaGen dump
GT_CHANNELS = 9                    # radiance(3) + diffuse(3) + albedo(3)
PATCH_SIZE = 128

# --- raw per-sample channel ranges (half-open [start, end)) ----------------
SUBPIXEL = (0, 2)
RADIANCE = (2, 5)
DIFFUSE = (5, 8)
ALBEDO_AT_FIRST = (8, 11)
ALBEDO = (11, 14)
NORMAL_AT_FIRST = (14, 17)
NORMAL = (17, 20)
DEPTH_AT_FIRST = (20, 21)
DEPTH = (21, 22)
VISIBILITY = (22, 23)
HAS_HIT = (23, 24)
PROBABILITIES = (24, 24 + 4 * N_BOUNCES)                      # (24, 48)
LIGHT_DIRECTIONS = (48, 48 + 2 * N_BOUNCES)                   # (48, 60)
BOUNCE_TYPES = (60, 60 + N_BOUNCES)                           # (60, 66)
ALBEDO_AT_DIFF = (66, 69)
NORMAL_AT_DIFF = (69, 72)
DEPTH_AT_DIFF = (72, 73)
PATH_WEIGHT = (73, 74)
RADIANCE_WO_WEIGHT = (74, 77)
LIGHT_INTENSITY = (77, 80)
THROUGHPUTS = (80, 80 + 3 * N_BOUNCES)                        # (80, 98)
ROUGHNESSES = (98, 98 + N_BOUNCES)                            # (98, 104)

assert ROUGHNESSES[1] == RAW_CHANNELS

# --- ground-truth channel ranges ------------------------------------------
GT_RADIANCE = (0, 3)
GT_DIFFUSE = (3, 6)
GT_ALBEDO = (6, 9)

# --- derived buffer channel counts ----------------------------------------
LLPM_CHANNELS = 37       # path_weight(1) rad_wo_w(3) light(3) thr(18) bt(6) rough(6)
PATH_CHANNELS = 36       # LLPM minus the leading path-weight column
SBMC_S_CHANNELS = 27     # total(3) log_total(3) log_spec(3) subpixel(2) g16
SBMC_P_CHANNELS = 66     # log probs(24) light dirs(12) 5 one-hot bits x 6
SBMC_G_CHANNELS = 16
KPCN_CHANNELS = 44

# channel ranges inside the cached 44-ch KPCN pixel buffer
KPCN_DIFFUSE = (0, 3)
KPCN_DIFFUSE_VAR = (3, 4)
KPCN_DIFFUSE_GRAD = (4, 10)
KPCN_SPECULAR = (10, 13)
KPCN_SPECULAR_VAR = (13, 14)
KPCN_SPECULAR_GRAD = (14, 20)
KPCN_NORMAL = (20, 23)
KPCN_NORMAL_VAR = (23, 24)
KPCN_NORMAL_GRAD = (24, 30)
KPCN_DEPTH = (30, 31)
KPCN_DEPTH_VAR = (31, 32)
KPCN_DEPTH_GRAD = (32, 34)
KPCN_ALBEDO = (34, 37)
KPCN_ALBEDO_VAR = (37, 38)
KPCN_ALBEDO_GRAD = (38, 44)

ALBEDO_EPS = 0.00316     # Bako et al. albedo-factorization epsilon

# channel ranges inside the cached SBMC sample buffer
SBMC_S_TOTAL = (0, 3)
SBMC_S_LOG_TOTAL = (3, 6)
SBMC_S_LOG_SPECULAR = (6, 9)
SBMC_S_SUBPIXEL = (9, 11)
SBMC_S_GBUF = (11, 27)
SBMC_S_NORMAL = (20, 23)   # normal at first non-specular bounce, inside g-buf

# channel ranges inside the cached SBMC path buffer
SBMC_P_PROBS = (0, 24)
SBMC_P_LIGHT_DIRS = (24, 36)
SBMC_P_IS_REFLECTION = (36, 42)
SBMC_P_IS_TRANSMISSION = (42, 48)
SBMC_P_IS_DIFFUSE = (48, 54)
SBMC_P_IS_GLOSSY = (54, 60)
SBMC_P_IS_SPECULAR = (60, 66)


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Input-channel bookkeeping for one model configuration.

    Mirrors the reference's channel-size computation
    (support/datasets.py:201-219): the denoiser input grows by
    ``pnet_out + 2`` (p-buffer + path weight + p-variance) when the LLPM
    path buffer is enabled, and the reconstruction half of a
    disentangled embedding is ``pnet_out // 2`` wide.
    """

    base_model: str                 # 'kpcn' | 'sbmc' | 'lbmc'
    use_g_buf: bool = True
    use_sbmc_buf: bool = True
    use_llpm_buf: bool = False
    pnet_out_size: int = 3
    disentangle: str = "m11r11"

    def __post_init__(self):
        if self.base_model not in ("kpcn", "sbmc", "lbmc"):
            raise ValueError(f"Unknown base model {self.base_model!r}")
        if self.disentangle not in ("m11r11", "m10r01", "m11r01", "m10r11"):
            raise ValueError(f"Unknown disentangle mode {self.disentangle!r}")
        if self.disentangle != "m11r11" and self.pnet_out_size % 2 != 0:
            raise ValueError("pnet_out_size must be even for disentangled modes")

    @property
    def pnet_in_size(self) -> int:
        return PATH_CHANNELS if self.use_llpm_buf else 0

    @property
    def recon_embed_size(self) -> int:
        """Channels of the embedding half fed to the denoiser."""
        if not self.use_llpm_buf:
            return 0
        if self.disentangle in ("m10r01", "m11r01"):
            return self.pnet_out_size // 2
        return self.pnet_out_size

    @property
    def dncnn_in_size(self) -> int:
        """Input channels of the denoiser backbone."""
        if self.base_model == "kpcn":
            n = 34
        else:  # sbmc / lbmc operate on the 'features' stack
            n = 3
            if self.use_g_buf:
                n += 21
            if self.base_model == "sbmc" and self.use_sbmc_buf:
                n += SBMC_P_CHANNELS
        if self.use_llpm_buf:
            n += self.recon_embed_size + 2   # + path weight + p-variance
        return n

    @property
    def features_size(self) -> int:
        """Channels of the on-disk 'features' stack (before p-buffer concat)."""
        if self.base_model == "kpcn":
            raise ValueError("'features' is a sample-space (sbmc/lbmc) key")
        n = 0
        if self.use_g_buf:
            n += 24
        if self.base_model == "sbmc" and self.use_sbmc_buf:
            n += SBMC_P_CHANNELS
        if n == 0:
            n = 3  # log-total fallback when neither aux buffer is enabled
        return n
