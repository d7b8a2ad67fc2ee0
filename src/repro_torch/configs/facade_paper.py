"""The paper's own experimental models (Sec. V-A):
GN-LeNet (CIFAR-10 / Imagenette) and ResNet8 (Flickr-Mammals)."""
from repro_torch.models.base import CNNConfig


def lenet(smoke: bool = False) -> CNNConfig:
    if smoke:
        return CNNConfig(name="gn-lenet-smoke", kind="lenet", image_size=16,
                         width=8, n_classes=10)
    return CNNConfig(name="gn-lenet", kind="lenet", image_size=32, width=32,
                     n_classes=10)


def resnet8(smoke: bool = False) -> CNNConfig:
    if smoke:
        return CNNConfig(name="resnet8-smoke", kind="resnet8", image_size=16,
                         width=16, n_classes=10)
    return CNNConfig(name="resnet8", kind="resnet8", image_size=64, width=32,
                     n_classes=41)  # Flickr-Mammals: 41 species
