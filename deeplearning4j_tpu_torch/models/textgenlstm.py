"""TextGenerationLSTM (counterpart of ``deeplearning4j_tpu/models/
textgenlstm.py``; reference zoo/model/TextGenerationLSTM.java): two stacked
GravesLSTM layers and a per-step softmax for character-level generation,
RmsProp 1e-2, Xavier init, trained with truncated BPTT of length 50.
BASELINE configs[2]."""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.recurrent import GravesLSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.optimize.updaters import RmsProp


class TextGenerationLSTM(ZooModel):
    def __init__(self, total_unique_characters: int = 47, seed: int = 12345,
                 units: int = 256, updater=None, tbptt_length: int = 50):
        super().__init__(total_unique_characters, seed)
        self.units = units
        self.updater = updater or RmsProp(learning_rate=1e-2)
        self.tbptt_length = tbptt_length

    def conf(self):
        v = self.num_classes
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).updater(self.updater).weight_init("xavier")
                .list()
                .layer(GravesLSTM(n_out=self.units, activation="tanh"))
                .layer(GravesLSTM(n_out=self.units, activation="tanh"))
                .layer(RnnOutputLayer(n_out=v, activation="softmax", loss="mcxent"))
                .set_input_type(InputType.recurrent(v))
                .backprop_type("tbptt", fwd_length=self.tbptt_length,
                               back_length=self.tbptt_length)
                .build())
