"""The port's model zoo.

Importing this package registers every model builder with the registry
(``utils.registry``).  The port carries ResNet-18/50 and EfficientNet-B0
(image classification), BERT-base, GPT-2 and SD-1.5 so far; the other
families of the JAX package (ViT-B/16, Whisper) follow slice by slice.
"""

from . import bert, efficientnet, gpt2, resnet, sd15  # noqa: F401
