"""The port's model zoo.

Importing this package registers every model builder with the registry
(``utils.registry``).  The port carries BERT-base, SD-1.5 and GPT-2 so far; the
other families of the JAX package follow slice by slice.
"""

from . import bert, gpt2, sd15  # noqa: F401
