from nornicdb_tpu_torch.models.encoder import Encoder, EncoderConfig  # noqa: F401
