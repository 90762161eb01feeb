"""AlphaFold-2 residue constants and all-atom backbone construction.
Counterpart of reed_tpu/ops/residue_constants.py, with its own copy of the
tables.

The numeric tables are the published AF2 stereochemical constants
(idealised rigid-group atom positions, atom37/atom14 orderings, chi-angle
definitions) as vendored by the reference at
protein/multiflow/data/residue_constants.py:126-545: measured physical
constants, reproduced verbatim (provenance: DeepMind AlphaFold,
Apache-2.0). The derived arrays are built with numpy on import; the frame,
atom14/atom37 and oxygen construction run in torch on the caller's device
(reference: protein/multiflow/data/all_atom.py:14-245 and
data/utils.py:108-180).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F




RESTYPES = ['A', 'R', 'N', 'D', 'C', 'Q', 'E', 'G', 'H', 'I', 'L', 'K', 'M', 'F', 'P', 'S', 'T', 'W', 'Y', 'V']

RESTYPE_1TO3 = {'A': 'ALA', 'R': 'ARG', 'N': 'ASN', 'D': 'ASP', 'C': 'CYS', 'Q': 'GLN', 'E': 'GLU', 'G': 'GLY', 'H': 'HIS', 'I': 'ILE', 'L': 'LEU', 'K': 'LYS', 'M': 'MET', 'F': 'PHE', 'P': 'PRO', 'S': 'SER', 'T': 'THR', 'W': 'TRP', 'Y': 'TYR', 'V': 'VAL'}

RESTYPE_3TO1 = {v: k for k, v in RESTYPE_1TO3.items()}

RESTYPE_ORDER = {r: i for i, r in enumerate(RESTYPES)}

UNK_RESTYPE_INDEX = 20  # 'X'

ATOM37_NAMES = ['N', 'CA', 'C', 'CB', 'O', 'CG', 'CG1', 'CG2', 'OG', 'OG1', 'SG', 'CD', 'CD1', 'CD2', 'ND1', 'ND2', 'OD1', 'OD2', 'SD', 'CE', 'CE1', 'CE2', 'CE3', 'NE', 'NE1', 'NE2', 'OE1', 'OE2', 'CH2', 'NH1', 'NH2', 'OH', 'CZ', 'CZ2', 'CZ3', 'NZ', 'OXT']

ATOM37_ORDER = {a: i for i, a in enumerate(ATOM37_NAMES)}

ATOM14_NAMES_BY_RESNAME = {
    'ALA': ['N', 'CA', 'C', 'O', 'CB', '', '', '', '', '', '', '', '', ''],
    'ARG': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD', 'NE', 'CZ', 'NH1', 'NH2', '', '', ''],
    'ASN': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'OD1', 'ND2', '', '', '', '', '', ''],
    'ASP': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'OD1', 'OD2', '', '', '', '', '', ''],
    'CYS': ['N', 'CA', 'C', 'O', 'CB', 'SG', '', '', '', '', '', '', '', ''],
    'GLN': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD', 'OE1', 'NE2', '', '', '', '', ''],
    'GLU': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD', 'OE1', 'OE2', '', '', '', '', ''],
    'GLY': ['N', 'CA', 'C', 'O', '', '', '', '', '', '', '', '', '', ''],
    'HIS': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'ND1', 'CD2', 'CE1', 'NE2', '', '', '', ''],
    'ILE': ['N', 'CA', 'C', 'O', 'CB', 'CG1', 'CG2', 'CD1', '', '', '', '', '', ''],
    'LEU': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD1', 'CD2', '', '', '', '', '', ''],
    'LYS': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD', 'CE', 'NZ', '', '', '', '', ''],
    'MET': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'SD', 'CE', '', '', '', '', '', ''],
    'PHE': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD1', 'CD2', 'CE1', 'CE2', 'CZ', '', '', ''],
    'PRO': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD', '', '', '', '', '', '', ''],
    'SER': ['N', 'CA', 'C', 'O', 'CB', 'OG', '', '', '', '', '', '', '', ''],
    'THR': ['N', 'CA', 'C', 'O', 'CB', 'OG1', 'CG2', '', '', '', '', '', '', ''],
    'TRP': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD1', 'CD2', 'NE1', 'CE2', 'CE3', 'CZ2', 'CZ3', 'CH2'],
    'TYR': ['N', 'CA', 'C', 'O', 'CB', 'CG', 'CD1', 'CD2', 'CE1', 'CE2', 'CZ', 'OH', '', ''],
    'VAL': ['N', 'CA', 'C', 'O', 'CB', 'CG1', 'CG2', '', '', '', '', '', '', ''],
    'UNK': ['', '', '', '', '', '', '', '', '', '', '', '', '', ''],
}

# (atom, rigid_group, (x, y, z)) per residue; groups: 0 backbone,
# 1 pre-omega, 2 phi, 3 psi, 4..7 chi1..4
RIGID_GROUP_ATOM_POSITIONS = {
    'ALA': [
        ('N', 0, (-0.525, 1.363, 0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.526, -0.000, -0.000)),
        ('CB', 0, (-0.529, -0.774, -1.205)),
        ('O', 3, (0.627, 1.062, 0.000)),
    ],
    'ARG': [
        ('N', 0, (-0.524, 1.362, -0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.525, -0.000, -0.000)),
        ('CB', 0, (-0.524, -0.778, -1.209)),
        ('O', 3, (0.626, 1.062, 0.000)),
        ('CG', 4, (0.616, 1.390, -0.000)),
        ('CD', 5, (0.564, 1.414, 0.000)),
        ('NE', 6, (0.539, 1.357, -0.000)),
        ('NH1', 7, (0.206, 2.301, 0.000)),
        ('NH2', 7, (2.078, 0.978, -0.000)),
        ('CZ', 7, (0.758, 1.093, -0.000)),
    ],
    'ASN': [
        ('N', 0, (-0.536, 1.357, 0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.526, -0.000, -0.000)),
        ('CB', 0, (-0.531, -0.787, -1.200)),
        ('O', 3, (0.625, 1.062, 0.000)),
        ('CG', 4, (0.584, 1.399, 0.000)),
        ('ND2', 5, (0.593, -1.188, 0.001)),
        ('OD1', 5, (0.633, 1.059, 0.000)),
    ],
    'ASP': [
        ('N', 0, (-0.525, 1.362, -0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.527, 0.000, -0.000)),
        ('CB', 0, (-0.526, -0.778, -1.208)),
        ('O', 3, (0.626, 1.062, -0.000)),
        ('CG', 4, (0.593, 1.398, -0.000)),
        ('OD1', 5, (0.610, 1.091, 0.000)),
        ('OD2', 5, (0.592, -1.101, -0.003)),
    ],
    'CYS': [
        ('N', 0, (-0.522, 1.362, -0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.524, 0.000, 0.000)),
        ('CB', 0, (-0.519, -0.773, -1.212)),
        ('O', 3, (0.625, 1.062, -0.000)),
        ('SG', 4, (0.728, 1.653, 0.000)),
    ],
    'GLN': [
        ('N', 0, (-0.526, 1.361, -0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.526, 0.000, 0.000)),
        ('CB', 0, (-0.525, -0.779, -1.207)),
        ('O', 3, (0.626, 1.062, -0.000)),
        ('CG', 4, (0.615, 1.393, 0.000)),
        ('CD', 5, (0.587, 1.399, -0.000)),
        ('NE2', 6, (0.593, -1.189, -0.001)),
        ('OE1', 6, (0.634, 1.060, 0.000)),
    ],
    'GLU': [
        ('N', 0, (-0.528, 1.361, 0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.526, -0.000, -0.000)),
        ('CB', 0, (-0.526, -0.781, -1.207)),
        ('O', 3, (0.626, 1.062, 0.000)),
        ('CG', 4, (0.615, 1.392, 0.000)),
        ('CD', 5, (0.600, 1.397, 0.000)),
        ('OE1', 6, (0.607, 1.095, -0.000)),
        ('OE2', 6, (0.589, -1.104, -0.001)),
    ],
    'GLY': [
        ('N', 0, (-0.572, 1.337, 0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.517, -0.000, -0.000)),
        ('O', 3, (0.626, 1.062, -0.000)),
    ],
    'HIS': [
        ('N', 0, (-0.527, 1.360, 0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.525, 0.000, 0.000)),
        ('CB', 0, (-0.525, -0.778, -1.208)),
        ('O', 3, (0.625, 1.063, 0.000)),
        ('CG', 4, (0.600, 1.370, -0.000)),
        ('CD2', 5, (0.889, -1.021, 0.003)),
        ('ND1', 5, (0.744, 1.160, -0.000)),
        ('CE1', 5, (2.030, 0.851, 0.002)),
        ('NE2', 5, (2.145, -0.466, 0.004)),
    ],
    'ILE': [
        ('N', 0, (-0.493, 1.373, -0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.527, -0.000, -0.000)),
        ('CB', 0, (-0.536, -0.793, -1.213)),
        ('O', 3, (0.627, 1.062, -0.000)),
        ('CG1', 4, (0.534, 1.437, -0.000)),
        ('CG2', 4, (0.540, -0.785, -1.199)),
        ('CD1', 5, (0.619, 1.391, 0.000)),
    ],
    'LEU': [
        ('N', 0, (-0.520, 1.363, 0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.525, -0.000, -0.000)),
        ('CB', 0, (-0.522, -0.773, -1.214)),
        ('O', 3, (0.625, 1.063, -0.000)),
        ('CG', 4, (0.678, 1.371, 0.000)),
        ('CD1', 5, (0.530, 1.430, -0.000)),
        ('CD2', 5, (0.535, -0.774, 1.200)),
    ],
    'LYS': [
        ('N', 0, (-0.526, 1.362, -0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.526, 0.000, 0.000)),
        ('CB', 0, (-0.524, -0.778, -1.208)),
        ('O', 3, (0.626, 1.062, -0.000)),
        ('CG', 4, (0.619, 1.390, 0.000)),
        ('CD', 5, (0.559, 1.417, 0.000)),
        ('CE', 6, (0.560, 1.416, 0.000)),
        ('NZ', 7, (0.554, 1.387, 0.000)),
    ],
    'MET': [
        ('N', 0, (-0.521, 1.364, -0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.525, 0.000, 0.000)),
        ('CB', 0, (-0.523, -0.776, -1.210)),
        ('O', 3, (0.625, 1.062, -0.000)),
        ('CG', 4, (0.613, 1.391, -0.000)),
        ('SD', 5, (0.703, 1.695, 0.000)),
        ('CE', 6, (0.320, 1.786, -0.000)),
    ],
    'PHE': [
        ('N', 0, (-0.518, 1.363, 0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.524, 0.000, -0.000)),
        ('CB', 0, (-0.525, -0.776, -1.212)),
        ('O', 3, (0.626, 1.062, -0.000)),
        ('CG', 4, (0.607, 1.377, 0.000)),
        ('CD1', 5, (0.709, 1.195, -0.000)),
        ('CD2', 5, (0.706, -1.196, 0.000)),
        ('CE1', 5, (2.102, 1.198, -0.000)),
        ('CE2', 5, (2.098, -1.201, -0.000)),
        ('CZ', 5, (2.794, -0.003, -0.001)),
    ],
    'PRO': [
        ('N', 0, (-0.566, 1.351, -0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.527, -0.000, 0.000)),
        ('CB', 0, (-0.546, -0.611, -1.293)),
        ('O', 3, (0.621, 1.066, 0.000)),
        ('CG', 4, (0.382, 1.445, 0.000)),
        ('CD', 5, (0.477, 1.424, 0.000)),
    ],
    'SER': [
        ('N', 0, (-0.529, 1.360, -0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.525, -0.000, -0.000)),
        ('CB', 0, (-0.518, -0.777, -1.211)),
        ('O', 3, (0.626, 1.062, -0.000)),
        ('OG', 4, (0.503, 1.325, 0.000)),
    ],
    'THR': [
        ('N', 0, (-0.517, 1.364, 0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.526, 0.000, -0.000)),
        ('CB', 0, (-0.516, -0.793, -1.215)),
        ('O', 3, (0.626, 1.062, 0.000)),
        ('CG2', 4, (0.550, -0.718, -1.228)),
        ('OG1', 4, (0.472, 1.353, 0.000)),
    ],
    'TRP': [
        ('N', 0, (-0.521, 1.363, 0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.525, -0.000, 0.000)),
        ('CB', 0, (-0.523, -0.776, -1.212)),
        ('O', 3, (0.627, 1.062, 0.000)),
        ('CG', 4, (0.609, 1.370, -0.000)),
        ('CD1', 5, (0.824, 1.091, 0.000)),
        ('CD2', 5, (0.854, -1.148, -0.005)),
        ('CE2', 5, (2.186, -0.678, -0.007)),
        ('CE3', 5, (0.622, -2.530, -0.007)),
        ('NE1', 5, (2.140, 0.690, -0.004)),
        ('CH2', 5, (3.028, -2.890, -0.013)),
        ('CZ2', 5, (3.283, -1.543, -0.011)),
        ('CZ3', 5, (1.715, -3.389, -0.011)),
    ],
    'TYR': [
        ('N', 0, (-0.522, 1.362, 0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.524, -0.000, -0.000)),
        ('CB', 0, (-0.522, -0.776, -1.213)),
        ('O', 3, (0.627, 1.062, -0.000)),
        ('CG', 4, (0.607, 1.382, -0.000)),
        ('CD1', 5, (0.716, 1.195, -0.000)),
        ('CD2', 5, (0.713, -1.194, -0.001)),
        ('CE1', 5, (2.107, 1.200, -0.002)),
        ('CE2', 5, (2.104, -1.201, -0.003)),
        ('OH', 5, (4.168, -0.002, -0.005)),
        ('CZ', 5, (2.791, -0.001, -0.003)),
    ],
    'VAL': [
        ('N', 0, (-0.494, 1.373, -0.000)),
        ('CA', 0, (0.000, 0.000, 0.000)),
        ('C', 0, (1.527, -0.000, -0.000)),
        ('CB', 0, (-0.533, -0.795, -1.213)),
        ('O', 3, (0.627, 1.062, -0.000)),
        ('CG1', 4, (0.540, 1.429, -0.000)),
        ('CG2', 4, (0.533, -0.776, 1.203)),
    ],
}

CHI_ANGLES_ATOMS = {
    'ALA': [],
    'ARG': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD'], ['CB', 'CG', 'CD', 'NE'], ['CG', 'CD', 'NE', 'CZ']],
    'ASN': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'OD1']],
    'ASP': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'OD1']],
    'CYS': [['N', 'CA', 'CB', 'SG']],
    'GLN': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD'], ['CB', 'CG', 'CD', 'OE1']],
    'GLU': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD'], ['CB', 'CG', 'CD', 'OE1']],
    'GLY': [],
    'HIS': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'ND1']],
    'ILE': [['N', 'CA', 'CB', 'CG1'], ['CA', 'CB', 'CG1', 'CD1']],
    'LEU': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD1']],
    'LYS': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD'], ['CB', 'CG', 'CD', 'CE'], ['CG', 'CD', 'CE', 'NZ']],
    'MET': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'SD'], ['CB', 'CG', 'SD', 'CE']],
    'PHE': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD1']],
    'PRO': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD']],
    'SER': [['N', 'CA', 'CB', 'OG']],
    'THR': [['N', 'CA', 'CB', 'OG1']],
    'TRP': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD1']],
    'TYR': [['N', 'CA', 'CB', 'CG'], ['CA', 'CB', 'CG', 'CD1']],
    'VAL': [['N', 'CA', 'CB', 'CG1']],
}

CHI_ANGLES_MASK = [[0.0, 0.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 0.0, 0.0], [1.0, 1.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0], [1.0, 1.0, 1.0, 0.0], [1.0, 1.0, 1.0, 0.0], [0.0, 0.0, 0.0, 0.0], [1.0, 1.0, 0.0, 0.0], [1.0, 1.0, 0.0, 0.0], [1.0, 1.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 0.0], [1.0, 1.0, 0.0, 0.0], [1.0, 1.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0], [1.0, 1.0, 0.0, 0.0], [1.0, 1.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0]]

# -- derived arrays (computed, not stored) ------------------------------------

NUM_RESTYPES = 21  # 20 + X


def _build_arrays():
    """(restype, atom) lookup arrays mirroring the reference's
    _make_rigid_group_constants (residue_constants.py:784-851)."""
    atom37_to_group = np.zeros((NUM_RESTYPES, 37), np.int32)
    atom37_mask = np.zeros((NUM_RESTYPES, 37), np.float32)
    atom37_pos = np.zeros((NUM_RESTYPES, 37, 3), np.float32)
    atom14_to_group = np.zeros((NUM_RESTYPES, 14), np.int32)
    atom14_mask = np.zeros((NUM_RESTYPES, 14), np.float32)
    atom14_pos = np.zeros((NUM_RESTYPES, 14, 3), np.float32)
    for restype, letter in enumerate(RESTYPES):
        resname = RESTYPE_1TO3[letter]
        names14 = ATOM14_NAMES_BY_RESNAME[resname]
        for name, group, pos in RIGID_GROUP_ATOM_POSITIONS[resname]:
            i37 = ATOM37_ORDER[name]
            atom37_to_group[restype, i37] = group
            atom37_mask[restype, i37] = 1.0
            atom37_pos[restype, i37] = pos
            i14 = names14.index(name)
            atom14_to_group[restype, i14] = group
            atom14_mask[restype, i14] = 1.0
            atom14_pos[restype, i14] = pos
    return (atom37_to_group, atom37_mask, atom37_pos,
            atom14_to_group, atom14_mask, atom14_pos)


(RESTYPE_ATOM37_TO_GROUP, RESTYPE_ATOM37_MASK, RESTYPE_ATOM37_POSITIONS,
 RESTYPE_ATOM14_TO_GROUP, RESTYPE_ATOM14_MASK, RESTYPE_ATOM14_POSITIONS,
 ) = _build_arrays()


def _rigid_4x4(ex, ey, translation):
    """Gram-Schmidt 4x4 from two axes (residue_constants.py:755-768)."""
    ex = ex / np.linalg.norm(ex)
    ey = ey - np.dot(ey, ex) * ex
    ey = ey / np.linalg.norm(ey)
    ez = np.cross(ex, ey)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = ex, ey, ez, translation
    return m


def _build_default_frames():
    """Per-restype rigid-group default frames [21, 8, 4, 4]
    (groups: bb, pre-omega, phi, psi, chi1..chi4)."""
    frames = np.tile(np.eye(4, dtype=np.float32), (NUM_RESTYPES, 8, 1, 1))
    for restype, letter in enumerate(RESTYPES):
        resname = RESTYPE_1TO3[letter]
        pos = {name: np.array(p)
               for name, _, p in RIGID_GROUP_ATOM_POSITIONS[resname]}
        frames[restype, 2] = _rigid_4x4(pos["N"] - pos["CA"],
                                        np.array([1.0, 0.0, 0.0]), pos["N"])
        frames[restype, 3] = _rigid_4x4(pos["C"] - pos["CA"],
                                        pos["CA"] - pos["N"], pos["C"])
        if CHI_ANGLES_MASK[restype][0]:
            a = [pos[n] for n in CHI_ANGLES_ATOMS[resname][0]]
            frames[restype, 4] = _rigid_4x4(a[2] - a[1], a[0] - a[1], a[2])
        for chi in range(1, 4):
            if CHI_ANGLES_MASK[restype][chi]:
                end = pos[CHI_ANGLES_ATOMS[resname][chi][2]]
                frames[restype, 4 + chi] = _rigid_4x4(
                    end, np.array([-1.0, 0.0, 0.0]), end)
    return frames


RESTYPE_RIGID_GROUP_DEFAULT_FRAME = _build_default_frames()



def _table(array, like):
    """A constant table on the device of the tensor `like`."""
    return torch.as_tensor(array, device=like.device)


def torsion_frames(rotmats, trans, torsions_sincos, aatypes):
    """Backbone rigids + 7 torsion angles -> all 8 rigid-group frames.

    rotmats [..., 3, 3], trans [..., 3], torsions_sincos [..., 7, 2]
    (sin, cos), aatypes [...] int. Returns (rot [..., 8, 3, 3],
    trans [..., 8, 3]) (reference: all_atom.py:29-101
    torsion_angles_to_frames over (rotmat, trans) pairs).
    """
    default = _table(RESTYPE_RIGID_GROUP_DEFAULT_FRAME, rotmats).to(rotmats.dtype)[aatypes]
    d_rot = default[..., :3, :3]                      # [..., 8, 3, 3]
    d_trans = default[..., :3, 3]                     # [..., 8, 3]

    # torsion rotation about local x: [1 0 0; 0 c -s; 0 s c], with the
    # backbone group taking the (sin 0, cos 1) identity slot
    bb = torch.stack([torch.zeros_like(torsions_sincos[..., :1, 0]),
                      torch.ones_like(torsions_sincos[..., :1, 1])], -1)
    tors = torch.cat([bb, torsions_sincos], dim=-2)   # [..., 8, 2]
    sin, cos = tors[..., 0], tors[..., 1]
    zeros, ones = torch.zeros_like(sin), torch.ones_like(sin)
    rot_x = torch.stack([
        torch.stack([ones, zeros, zeros], -1),
        torch.stack([zeros, cos, -sin], -1),
        torch.stack([zeros, sin, cos], -1)], -2)      # [..., 8, 3, 3]

    # frame to backbone: default o rot_x; chi2..4 chain onto the previous chi
    g_rot = d_rot @ rot_x
    rots = [g_rot[..., i, :, :] for i in range(8)]
    ts = [d_trans[..., i, :] for i in range(8)]
    for i in (5, 6, 7):
        rots[i] = rots[i - 1] @ rots[i]
        ts[i] = torch.einsum("...ij,...j->...i", rots[i - 1], ts[i]) + ts[i - 1]
    g_rot = torch.stack(rots, -3)
    g_trans = torch.stack(ts, -2)

    # compose with the global backbone rigid
    out_rot = rotmats[..., None, :, :] @ g_rot
    out_trans = torch.einsum("...ij,...gj->...gi", rotmats, g_trans) + trans[..., None, :]
    return out_rot, out_trans


def frames_to_atom14(frame_rot, frame_trans, aatypes):
    """All 8 frames -> idealised atom14 positions [..., 14, 3] and their
    mask (all_atom.py:117-149)."""
    group = _table(RESTYPE_ATOM14_TO_GROUP, aatypes).long()[aatypes]          # [..., 14]
    mask = _table(RESTYPE_ATOM14_MASK, aatypes).to(frame_rot.dtype)[aatypes]  # [..., 14]
    local = _table(RESTYPE_ATOM14_POSITIONS, aatypes).to(frame_rot.dtype)[aatypes]
    onehot = F.one_hot(group, 8).to(frame_rot.dtype)                          # [..., 14, 8]
    rot = torch.einsum("...ag,...gij->...aij", onehot, frame_rot)
    t = torch.einsum("...ag,...gi->...ai", onehot, frame_trans)
    pos = torch.einsum("...aij,...aj->...ai", rot, local) + t
    return pos * mask[..., None], mask


def _unit(v, eps):
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + eps)


def adjust_oxygen_pos(atom37, res_mask=None):
    """Impute the backbone O in the CA-C-(next N) plane, 1.23 A from C
    (data/utils.py:108-180, over the batch); the last residue (or one
    whose next is masked) takes the N-CA-C plane."""
    eps = 1e-7
    n, ca, c = atom37[..., 0, :], atom37[..., 1, :], atom37[..., 2, :]
    next_n = torch.roll(n, -1, dims=-2)
    ca_to_c = _unit(c - ca, eps)
    nn_to_c = _unit(c - next_n, eps)
    o_dir_mid = _unit(ca_to_c + nn_to_c, eps)
    ca_to_n = _unit(n - ca, eps)
    o_dir_term = _unit(ca_to_c + 0.5 * (ca_to_c - ca_to_n), eps)

    length = atom37.shape[-3]
    is_last = torch.arange(length, device=atom37.device) == length - 1
    if res_mask is not None:
        next_known = torch.roll(res_mask, -1, dims=-1) > 0
    else:
        next_known = torch.ones(length, dtype=torch.bool, device=atom37.device)
    use_mid = (~is_last) & next_known
    o = c + 1.23 * torch.where(use_mid[..., None], o_dir_mid, o_dir_term)
    out = atom37.clone()
    out[..., 4, :] = o
    return out


def to_atom37(trans, rotmats, res_mask=None, impute_oxygen=True):
    """Backbone rigids -> atom37 positions [..., 37, 3] with N, CA, C, CB
    and O filled (atom37 order N, CA, C, CB, O): ALA geometry at psi 0, O
    then imputed from the adjacent frames (all_atom.py:20-27, 220-245)."""
    ala = 0
    local = np.array(RESTYPE_ATOM37_POSITIONS[ala, :5])       # N, CA, C, CB, O
    # O's table entry lives in its psi-group frame: express it in the
    # backbone frame at psi 0
    f3 = RESTYPE_RIGID_GROUP_DEFAULT_FRAME[ala, 3]
    local[4] = (f3 @ np.array([*local[4], 1.0]))[:3]
    local = torch.as_tensor(local, dtype=trans.dtype, device=trans.device)
    bb5 = torch.einsum("...ij,aj->...ai", rotmats, local) + trans[..., None, :]
    atom37 = torch.zeros(trans.shape[:-1] + (37, 3), dtype=trans.dtype, device=trans.device)
    atom37[..., :5, :] = bb5
    if impute_oxygen:
        atom37 = adjust_oxygen_pos(atom37, res_mask)
    return atom37
