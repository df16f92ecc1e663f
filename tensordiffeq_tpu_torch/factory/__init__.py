"""The surrogate factory: a parametric family of PINNs trained as one
captured step (the JAX package's ``factory/``).

See :mod:`tensordiffeq_tpu_torch.factory.family` for the design.
"""

from .family import (FAMILY_MANIFEST, SurrogateFactory,  # noqa: F401
                     member_slice, stack_members)
