"""The port's model zoo.

Importing this package registers every model builder with the registry
(``utils.registry``).  The port carries BERT-base and SD-1.5 so far; the
other families of the JAX package follow slice by slice.
"""

from . import bert, sd15  # noqa: F401
