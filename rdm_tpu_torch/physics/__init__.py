from .cr3bp import (CR3BP_MU, coe2rv, get_gto_state_cr3bp,  # noqa: F401
                    jacobi_energy, l1_position, spiral_to_boundary)
from .oracle import (CR3BPEarthMissionWarmstartSimulatorBoundary,  # noqa: F401
                     PYDYLAN_AVAILABLE)
