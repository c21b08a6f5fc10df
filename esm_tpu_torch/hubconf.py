"""torch.hub entry points of the port: every name of the root hubconf.py
(reference hubconf.py:8-43), each the port's constructor in
``esm_tpu_torch.pretrained``.

    torch.hub.load("<repo>/esm_tpu_torch", "esm2_t33_650M_UR50D", source="local")

Checkpoints resolve from the local cache only (``ESM_TPU_CACHE``): nothing
is downloaded. The constructors run on CUDA unless given ``device="cpu"``.
"""

import os
import sys

dependencies = ["torch", "numpy"]

# torch.hub puts this directory on sys.path; the package's own imports need
# its parent
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from esm_tpu_torch.pretrained import (  # noqa: F401,E402
    esm1_t6_43M_UR50S,
    esm1_t12_85M_UR50S,
    esm1_t34_670M_UR50S,
    esm1_t34_670M_UR50D,
    esm1_t34_670M_UR100,
    esm1b_t33_650M_UR50S,
    esm1v_t33_650M_UR90S,
    esm1v_t33_650M_UR90S_1,
    esm1v_t33_650M_UR90S_2,
    esm1v_t33_650M_UR90S_3,
    esm1v_t33_650M_UR90S_4,
    esm1v_t33_650M_UR90S_5,
    esm_if1_gvp4_t16_142M_UR50,
    esm_msa1_t12_100M_UR50S,
    esm_msa1b_t12_100M_UR50S,
    esm2_t6_8M_UR50D,
    esm2_t12_35M_UR50D,
    esm2_t30_150M_UR50D,
    esm2_t33_650M_UR50D,
    esm2_t36_3B_UR50D,
    esm2_t48_15B_UR50D,
    esmfold_structure_module_only_8M,
    esmfold_structure_module_only_8M_270K,
    esmfold_structure_module_only_35M,
    esmfold_structure_module_only_35M_270K,
    esmfold_structure_module_only_150M,
    esmfold_structure_module_only_150M_270K,
    esmfold_structure_module_only_650M,
    esmfold_structure_module_only_650M_270K,
    esmfold_structure_module_only_3B,
    esmfold_structure_module_only_3B_270K,
    esmfold_structure_module_only_15B,
    esmfold_v0,
    esmfold_v1,
)
