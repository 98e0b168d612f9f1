from mage_tpu_torch.models.autoencoder_kl import AutoencoderKL
from mage_tpu_torch.models.mage import FlatAxialDecoder, MAGECore
from mage_tpu_torch.models.pipeline import FirstStageKL, MagePipeline, build_pipeline
from mage_tpu_torch.models.vqvae import VectorQuantizedVAE
