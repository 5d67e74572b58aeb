"""On-disk index bundle: one .npz of device-layout arrays + a JSON
manifest (version, contig table, build options).

This replaces the reference's 19-file index set (Index_src/index1.c:38-43,
loaded by Align_src/indexio.c:23-50) with a single versioned bundle that
host processes can memory-map and shard.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .build import Contig, SaltIndex

FORMAT_VERSION = 1


def save_index(idx: SaltIndex, prefix: str, compress: bool = None) -> None:
    """Write the bundle.  `compress` None takes SALT_TPU_STORE_COMPRESS
    (default on)."""
    manifest = {
        "format_version": FORMAT_VERSION,
        "l_seed": idx.l_seed,
        "l_pac": idx.l_pac,
        "c_primary": idx.c_primary,
        "r_primary": idx.r_primary,
        "r_text_len": idx.r_text_len,
        "max_seg_len": idx.max_seg_len,
        "contigs": [
            {
                "name": c.name,
                "anno": c.anno,
                "offset": c.offset,
                "length": c.length,
                "n_ambs": c.n_ambs,
            }
            for c in idx.contigs
        ],
    }
    with open(prefix + ".salt.json", "w") as fh:
        json.dump(manifest, fh)
    # deflate runs at a few MB/s single-threaded — a whole-genome
    # bundle (~26GB raw) takes the better part of an hour to compress
    # and minutes to decompress.  SALT_TPU_STORE_COMPRESS=0 stores raw
    # (disk-speed save/load, ~2x the bytes).
    if compress is None:
        compress = os.environ.get("SALT_TPU_STORE_COMPRESS", "1") != "0"
    writer = np.savez_compressed if compress else np.savez
    writer(
        prefix + ".salt.npz",
        pac=idx.pac,
        mixref=idx.mixref,
        lkt=idx.lkt,
        cbwt=idx.cbwt,
        c_l2=idx.c_l2,
        csa=idx.csa,
        rbwt=idx.rbwt,
        r_cumfreq=idx.r_cumfreq,
        r_coord=idx.r_coord,
        r_lkt_sp=idx.r_lkt_sp,
        r_lkt_ep=idx.r_lkt_ep,
        sharp_bases=(idx.sharp_bases if idx.sharp_bases is not None
                     else np.zeros(0, np.uint32)),
    )


def load_index(prefix: str) -> SaltIndex:
    with open(prefix + ".salt.json") as fh:
        m = json.load(fh)
    if m["format_version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported index format {m['format_version']}")
    z = np.load(prefix + ".salt.npz")
    contigs = [
        Contig(
            name=c["name"],
            anno=c["anno"],
            offset=c["offset"],
            length=c["length"],
            n_ambs=c["n_ambs"],
        )
        for c in m["contigs"]
    ]
    return SaltIndex(
        l_seed=m["l_seed"],
        contigs=contigs,
        l_pac=m["l_pac"],
        pac=z["pac"],
        mixref=z["mixref"],
        lkt=z["lkt"],
        cbwt=z["cbwt"],
        c_l2=z["c_l2"],
        c_primary=m["c_primary"],
        csa=z["csa"],
        r_text_len=m["r_text_len"],
        rbwt=z["rbwt"],
        r_cumfreq=z["r_cumfreq"],
        r_primary=m["r_primary"],
        r_coord=z["r_coord"],
        r_lkt_sp=z["r_lkt_sp"] if "r_lkt_sp" in z else None,
        r_lkt_ep=z["r_lkt_ep"] if "r_lkt_ep" in z else None,
        # empty is a VALID value (zero-SNP index); only a missing key
        # (pre-sharp_bases bundle) maps to None
        sharp_bases=z["sharp_bases"] if "sharp_bases" in z else None,
        max_seg_len=m.get("max_seg_len", 0),
    )
