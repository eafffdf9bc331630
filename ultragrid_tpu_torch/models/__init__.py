"""The port's flagship device pipelines ("models"): the sender's encode
graphs, frame in -> compress -> FEC parity on the card.  Importing the
package builds no kernel: the kernels build at their first launch."""

from ultragrid_tpu_torch.models.encode import EncodePipeline  # noqa: F401
