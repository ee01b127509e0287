from .cnn import CnnPolicy, PolicyOutput
from .impala import CoreInputs, ImpalaLstmPolicy, LstmCarry
