"""SIDD .MAT metadata parsing and the gated camera-file metadata readers
(port of yondx/isp/metadata.py, copied: numpy over a `scipy.io.loadmat`
struct). `read_wb_ccm` needs rawpy and `get_iso_exposure` exifread; where
the package is absent they raise ImportError."""
from __future__ import annotations

import numpy as np


def read_wb_ccm(path: str):
    """White balance (normalized to green) and the 3x3 colour matrix of a
    camera raw, through rawpy."""
    try:
        import rawpy
    except ImportError as e:
        raise ImportError("read_wb_ccm needs rawpy/LibRaw (not available "
                          "in this environment)") from e
    with rawpy.imread(path) as raw:
        wb = np.array(raw.camera_whitebalance, np.float32)
        wb = wb / wb[1]
        ccm = np.array(raw.color_matrix[:3, :3], np.float32)
        return wb, ccm


def get_iso_exposure(path: str):
    """EXIF ISO and exposure time (s), through exifread."""
    try:
        import exifread
    except ImportError as e:
        raise ImportError("get_iso_exposure needs exifread (not available "
                          "in this environment)") from e
    with open(path, "rb") as f:
        tags = exifread.process_file(f)
    iso = int(str(tags.get("EXIF ISOSpeedRatings", 0)))
    expo = str(tags.get("EXIF ExposureTime", "0"))
    if "/" in expo:
        a, b = expo.split("/")
        exposure = float(a) / float(b)
    else:
        exposure = float(expo)
    return iso, exposure


_CAM_DICT = {"Apple": "IP", "Google": "GP", "samsung": "S6",
             "motorola": "N6", "LGE": "G4"}
_BAYER_TAG_ID = 33422


def _get_iso(meta):
    try:
        return meta["ISOSpeedRatings"][0][0]
    except Exception:
        return meta["DigitalCamera"][0, 0]["ISOSpeedRatings"][0][0]


def _get_bayer_pattern(meta):
    """The CFA tag (33422) from the first of its three locations that
    holds it; RGGB when none does."""
    for grab in (
        lambda m: m["UnknownTags"],
        lambda m: m["SubIFDs"][0, 0]["UnknownTags"][0, 0],
        lambda m: m["SubIFDs"][0, 1]["UnknownTags"],
    ):
        try:
            tags = grab(meta)
            if tags[1]["ID"][0][0][0] == _BAYER_TAG_ID:
                return tags[1]["Value"][0][0]
        except Exception:
            continue
    return [1, 2, 2, 3]  # assume RGGB


def read_sidd_metadata(matdata) -> dict:
    """A loaded *_METADATA_*.MAT dict -> the pipeline's metadata: the
    noise-model betas of UnknownTags[7], the camera code, the 2x2 bayer
    pattern (the S6's forced to GBRG), wb, CST2 and the ISO."""
    meta = matdata["metadata"][0, 0]
    beta1, beta2 = meta["UnknownTags"][7, 0][2][0][0:2]
    cam = _CAM_DICT[meta["Make"][0]]
    bayer_pattern = _get_bayer_pattern(meta)
    if cam == "S6":
        bayer_pattern = [1, 2, 0, 1]  # the corrected GBRG
    bayer_2by2 = (np.asarray(bayer_pattern) + 1).reshape((2, 2)).tolist()
    wb = meta["AsShotNeutral"]
    cst2 = meta["ColorMatrix2"].reshape((3, 3))
    iso = _get_iso(meta)
    return {
        "meta": meta, "beta1": beta1, "beta2": beta2,
        "bayer_2by2": bayer_2by2, "wb": wb, "cst2": cst2,
        "iso": iso, "cam": cam,
    }
