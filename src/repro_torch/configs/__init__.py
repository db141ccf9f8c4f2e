"""Architecture registry — importing this package registers every config
the port serves: the paper's own models."""
from repro_torch.configs import paper_models  # noqa: F401

PAPER = ("mnist-cnn", "cifar10-resnet18", "cifar100-resnet32")
