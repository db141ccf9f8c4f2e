"""The paper's own models (Sec. IV): 2-layer CNN for MNIST, ResNet18/8 for
CIFAR10 and ResNet32/18 for CIFAR100.  Teachers registered here; students
derive via :func:`repro_torch.models.derive_student` (half channels / smaller
resnet, per the paper).
"""
from repro_torch.config.base import ModelConfig, register


@register("mnist-cnn")
def mnist_cnn() -> ModelConfig:
    return ModelConfig(
        name="mnist-cnn",
        family="cnn",
        cnn_channels=(32, 64),
        input_hw=(28, 28, 1),
        num_classes=10,
        proto_dim=128,
        source="ProFe Sec. IV (MNIST teacher: 2-layer CNN)",
    )


@register("cifar10-resnet18")
def cifar10_resnet18() -> ModelConfig:
    return ModelConfig(
        name="cifar10-resnet18",
        family="resnet",
        resnet_blocks=(2, 2, 2, 2),
        resnet_width=64,
        input_hw=(32, 32, 3),
        num_classes=10,
        proto_dim=256,
        source="ProFe Sec. IV (CIFAR10 teacher ResNet18, student ResNet8)",
    )


@register("cifar100-resnet32")
def cifar100_resnet32() -> ModelConfig:
    return ModelConfig(
        name="cifar100-resnet32",
        family="resnet",
        resnet_blocks=(5, 5, 5),
        resnet_width=16,
        input_hw=(32, 32, 3),
        num_classes=100,
        proto_dim=256,
        source="ProFe Sec. IV (CIFAR100 teacher ResNet32, student ResNet18)",
    )
