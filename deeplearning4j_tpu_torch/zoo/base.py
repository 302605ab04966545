"""Zoo base: named architectures over the configuration DSL, with
pretrained weights restored from a local cache.

Counterpart of ``deeplearning4j_tpu/zoo/base.py`` (the reference's
``ZooModel``, ``ModelMetaData`` and ``DL4JResources``).
``init_model(device=...)`` builds and initialises the network with random
weights from ``seed``. ``init_pretrained`` is cache-first: an explicit
``path``, else the ``weights_fetcher`` hook, else the published
artifact's copy in ``cache_dir()`` (under the ``home`` property),
Adler32-verified; ``download_to_cache`` reads ``file://`` URLs and
nothing over the network. No pretrained weights ship with the port. A
serde zip restores through ``nn.serde.restore_model``, a DL4J
ModelSerializer zip (``coefficients.bin``) through
``zoo/dl4j_import.py``, both onto ``device``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import urllib.parse
import urllib.request
from typing import Callable, Optional, Tuple


class PretrainedType:
    IMAGENET = "imagenet"
    MNIST = "mnist"
    CIFAR10 = "cifar10"
    VGGFACE = "vggface"
    SEGMENT = "segment"


#: Optional hook: (model_name, pretrained_type) -> local file path.
#: Takes precedence over the URL registry below, so air-gapped installs can
#: point at a mirror without touching model classes.
weights_fetcher: Optional[Callable[[str, str], str]] = None


def set_weights_fetcher(fn: Optional[Callable[[str, str], str]]) -> None:
    """Register the pretrained-weights fetch hook (read by init_pretrained)."""
    global weights_fetcher
    weights_fetcher = fn


# -- pretrained artifact resolution (reference DL4JResources.java +
#    ZooModel.java initPretrained: URL -> cache -> Adler32 check -> restore)

#: Base URL for published artifacts; same default as the reference's
#: DL4JResources.DL4J_DEFAULT_URL, overridable for mirrors
#: (DL4JResources.java:43 / setBaseDownloadURL).
def _norm_base(url: str) -> str:
    return url if url.endswith("/") else url + "/"


_base_download_url = _norm_base(os.environ.get(
    "DL4J_RESOURCES_BASE_URL", "https://dl4jdata.blob.core.windows.net/"))


def set_base_download_url(url: str) -> None:
    global _base_download_url
    _base_download_url = _norm_base(url)


def get_url_string(relative: str) -> str:
    """DL4JResources.getURLString: base + relative path."""
    return _base_download_url + relative.lstrip("/")


def cache_dir() -> str:
    """Local artifact cache (reference: ~/.deeplearning4j/models), rooted
    at ``Environment.home_dir()`` (``DL4J_TPU_HOME``)."""
    from ..common.environment import environment
    return os.path.join(environment().home_dir(), "models")


def adler32_file(path: str) -> int:
    """Checksum matching the reference's FileUtils.checksum(file, new
    Adler32()) in ZooModel.initPretrained (ZooModel.java:85)."""
    import zlib
    value = 1
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            value = zlib.adler32(chunk, value)
    return value & 0xFFFFFFFF


def _md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


#: Published artifacts: class name -> {ptype: (relative URL, Adler32)}.
#: Values transcribed from the reference zoo classes' pretrainedUrl() /
#: pretrainedChecksum() (deeplearning4j-zoo/.../zoo/model/*.java).
PRETRAINED_REGISTRY = {
    "LeNet": {"mnist": ("models/lenet_dl4j_mnist_inference.zip",
                        1906861161)},
    "ResNet50": {"imagenet": ("models/resnet50_dl4j_inference.v3.zip",
                              3914447815)},
    "VGG16": {"imagenet": ("models/vgg16_dl4j_inference.zip", 3501732770),
              "cifar10": ("models/vgg16_dl4j_cifar10_inference.v1.zip",
                          2192260131),
              "vggface": ("models/vgg16_dl4j_vggface_inference.v1.zip",
                          2706403553)},
    "VGG19": {"imagenet": ("models/vgg19_dl4j_inference.zip", 2782932419)},
    "SqueezeNet": {"imagenet": ("models/squeezenet_dl4j_inference.v2.zip",
                                3711411239)},
    "TinyYOLO": {"imagenet": ("models/tiny-yolo-voc_dl4j_inference.v2.zip",
                              1256226465)},
    "Darknet19": {"imagenet": ("models/darknet19_dl4j_inference.v2.zip",
                               691100891)},
    # Darknet19 at 448x448 input: reference switches artifact by inputShape
    "Darknet19_448": {"imagenet": (
        "models/darknet19_448_dl4j_inference.v2.zip", 1054319943)},
    "UNet": {"segment": ("models/unet_dl4j_segment_inference.v1.zip",
                         712347958)},
    "Xception": {"imagenet": ("models/xception_dl4j_inference.v2.zip",
                              3277876097)},
    "YOLO2": {"imagenet": ("models/yolo2_dl4j_inference.v3.zip",
                           3658373840)},
}


def download_to_cache(url: str, model_name: str, filename: str,
                      expected_adler32: Optional[int] = None,
                      force: bool = False) -> str:
    """Bring ``url`` into the model cache, Adler32-verified (reference
    ``ZooModel.initPretrained``): a cached file whose checksum matches is
    used as it is; otherwise a ``file://`` URL is copied in once more, and
    a copy that still fails its checksum is removed and raises.

    The port reads no network: a URL of another scheme is used only
    through a copy already in the cache, and raises
    ``FileNotFoundError`` naming where to put the file when there is
    none."""
    dest_dir = os.path.join(cache_dir(), model_name)
    os.makedirs(dest_dir, exist_ok=True)
    dest = os.path.join(dest_dir, filename)

    def _fetch():
        parsed = urllib.parse.urlparse(url)
        if parsed.scheme != "file":
            raise FileNotFoundError(
                f"{model_name}: {url} is not in the local cache ({dest}) and"
                " the port fetches nothing over the network; place the file"
                " there, or pass a file:// URL or path=")
        # a pid-suffixed temporary and an atomic replace: concurrent
        # readers of a shared cache never see a partial file
        tmp = f"{dest}.part{os.getpid()}"
        try:
            shutil.copyfile(urllib.request.url2pathname(parsed.path), tmp)
            os.replace(tmp, dest)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    fresh = force or not os.path.exists(dest)
    if fresh:
        _fetch()
    if expected_adler32 is not None and adler32_file(dest) != expected_adler32:
        if not fresh:
            # a stale cached copy: one fetch again, as the reference does
            _fetch()
        if adler32_file(dest) != expected_adler32:
            os.remove(dest)
            raise ValueError(
                f"Pretrained model file failed checksum for {model_name}: "
                f"{url} (expected adler32={expected_adler32})")
    return dest


@dataclasses.dataclass
class ZooModel:
    """Base class for zoo architectures (reference zoo/ZooModel.java)."""
    num_classes: int = 1000
    seed: int = 123
    input_shape: Tuple[int, int, int] = (3, 224, 224)  # (C, H, W)
    #: compute dtype of the built network ("bfloat16": bf16 body with f32
    #: masters, see the configuration's dtype)
    dtype: str = "float32"

    #: md5 of the pretrained artifact, when one is published (local-path flow)
    pretrained_checksums: dict = dataclasses.field(default_factory=dict)
    #: ptype -> path relative to the resources base URL
    #: (reference pretrainedUrl(); values from the zoo model classes)
    pretrained_urls: dict = dataclasses.field(default_factory=dict)
    #: ptype -> Adler32 checksum (reference pretrainedChecksum())
    pretrained_adler32: dict = dataclasses.field(default_factory=dict)

    def conf(self):
        raise NotImplementedError

    def build_conf(self):
        """``self.conf()`` with the zoo-level dtype applied."""
        conf = self.conf()
        if self.dtype and self.dtype != "float32":
            conf.dtype = self.dtype
        return conf

    def init_model(self, device="cuda"):
        """Build + init the network on ``device``."""
        from ..nn.multilayer import MultiLayerNetwork
        return MultiLayerNetwork(self.build_conf(), device=device).init()

    def _registry_key(self) -> str:
        name = type(self).__name__
        if name == "Darknet19" and tuple(self.input_shape[1:]) == (448, 448):
            return "Darknet19_448"
        return name

    def _published(self, ptype: str):
        """(relative_url, adler32): instance overrides, then the registry."""
        if ptype in self.pretrained_urls:
            return (self.pretrained_urls[ptype],
                    self.pretrained_adler32.get(ptype))
        entry = PRETRAINED_REGISTRY.get(self._registry_key(), {})
        return entry.get(ptype, (None, None))

    def pretrained_available(self, ptype: str = PretrainedType.IMAGENET
                             ) -> bool:
        return (ptype in self.pretrained_checksums
                or self._published(ptype)[0] is not None)

    def pretrained_url(self, ptype: str = PretrainedType.IMAGENET
                       ) -> Optional[str]:
        """Full artifact URL (reference ZooModel.pretrainedUrl)."""
        rel = self._published(ptype)[0]
        return get_url_string(rel) if rel else None

    def pretrained_checksum(self, ptype: str = PretrainedType.IMAGENET
                            ) -> Optional[int]:
        """Adler32 of the published artifact (ZooModel.pretrainedChecksum)."""
        return self._published(ptype)[1]

    def init_pretrained(self, ptype: str = PretrainedType.IMAGENET,
                        path: Optional[str] = None, device="cuda"):
        """Load pretrained weights onto ``device`` (reference
        ZooModel.initPretrained). Resolution order: ``path``, then the
        ``weights_fetcher`` hook, then the published artifact through
        :func:`download_to_cache` (cache first, Adler32-verified)."""
        name = type(self).__name__
        if path is None and weights_fetcher is not None:
            path = weights_fetcher(name, ptype)
        if path is None:
            url = self.pretrained_url(ptype)
            if url is None:
                raise RuntimeError(
                    f"{name} publishes no pretrained weights for "
                    f"'{ptype}'; pass path= to a local artifact")
            path = download_to_cache(
                url, name, url.rsplit("/", 1)[-1],
                expected_adler32=self.pretrained_checksum(ptype))
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        want = self.pretrained_checksums.get(ptype)
        if want is not None and _md5(path) != want:
            raise ValueError(f"checksum mismatch for {name}:{ptype}")
        import zipfile
        with zipfile.ZipFile(path) as z:
            names = set(z.namelist())
        if "coefficients.bin" in names:
            # a reference-published DL4J zip (configuration.json +
            # coefficients.bin) converts via the ModelSerializer reader
            from .dl4j_import import restore_multi_layer_network
            return restore_multi_layer_network(path, device=device)
        from ..nn import serde
        # the artifact carries the config and every param, the state_*
        # running stats (batch-norm means and variances) included
        return serde.restore_model(path, device=device)
