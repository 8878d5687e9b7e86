"""The port's model zoo.

Importing this package registers every model builder with the registry
(``utils.registry``): ResNet-18/50, EfficientNet-B0 and ViT-B/16 (image
classification), BERT-base (classification and ``bert_embed``), GPT-2,
Whisper-tiny and SD-1.5, the JAX package's zoo.
"""

from . import bert, efficientnet, gpt2, resnet, sd15, vit, whisper  # noqa: F401
