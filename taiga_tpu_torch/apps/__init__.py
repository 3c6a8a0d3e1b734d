"""Applications: example resource logics.

Copy of the part of taiga_tpu/apps the port runs so far: the trivial
resource logic (taiga_halo2/src/circuit/resource_logic_examples.rs), the
no-op validity predicate of padding resources. The other example logics
come with later slices.

Importing this package registers the logic in the resource-logic bytecode
registry (circuits/bytecode.py).
"""

from . import trivial  # noqa: F401  (registration side effect)
from .trivial import TrivialResourceLogicCircuit
