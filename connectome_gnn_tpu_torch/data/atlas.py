"""Brain parcellation atlas.

83-region atlas used by the synthetic connectome generator: an abbreviated
Desikan-Killiany cortical parcellation plus subcortical structures and summary
white-matter tracts.  Mirrors the region inventory of the reference suite
exactly (`connectome_gnn/synthetic.py:38-90` — note the reference labels its
list "84 ROIs" but it actually contains 83 names; we match the actual list,
so datasets are region-for-region compatible).
"""

from __future__ import annotations

_CORTICAL_BILATERAL = [
    # Frontal
    "superiorfrontal",
    "rostralmiddlefrontal",
    "caudalmiddlefrontal",
    "parsopercularis",
    "parsorbitalis",
    "parstriangularis",
    "lateralorbitofrontal",
    "medialorbitofrontal",
    "precentral",
    # Parietal
    "superiorparietal",
    "inferiorparietal",
    "supramarginal",
    "postcentral",
    "precuneus",
    "posteriorcingulate",
    "isthmuscingulate",
    # Temporal
    "superiortemporal",
    "middletemporal",
    "inferiortemporal",
    "fusiform",
    "entorhinal",
    "parahippocampal",
    "transversetemporal",
    # Occipital
    "lateraloccipital",
    "lingual",
    "cuneus",
    "pericalcarine",
    # Cingulate / limbic
    "rostralanteriorcingulate",
    "caudalanteriorcingulate",
    "paracingulate",
]

_SUBCORTICAL_BILATERAL = [
    "Thalamus",
    "Caudate",
    "Putamen",
    "Pallidum",
    "Hippocampus",
    "Amygdala",
    "Accumbens-area",
]

_TRACTS = [
    "CC_anterior",
    "CC_posterior",
    "UncF_left",
    "UncF_right",
    "ILF_left",
    "ILF_right",
    "CST_left",
    "CST_right",
]


def _expand() -> list[str]:
    names: list[str] = []
    for roi in _CORTICAL_BILATERAL:
        names.append(f"ctx-lh-{roi}")
        names.append(f"ctx-rh-{roi}")
    for roi in _SUBCORTICAL_BILATERAL:
        names.append(f"Left-{roi}")
        names.append(f"Right-{roi}")
    names.append("Brain-Stem")
    names.extend(_TRACTS)
    return names


REGION_NAMES: list[str] = _expand()
NUM_REGIONS: int = len(REGION_NAMES)  # 83 (the reference's "84 ROIs" comment miscounts)
