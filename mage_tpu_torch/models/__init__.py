from mage_tpu_torch.models.mage import FlatAxialDecoder, MAGECore
from mage_tpu_torch.models.pipeline import MagePipeline, build_pipeline
from mage_tpu_torch.models.vqvae import VectorQuantizedVAE
