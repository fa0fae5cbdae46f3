from .comirec import ComirecDR, ComirecSA
from .dssm import DSSM, DSSMSENet
from .dssm_facebook import FaceBookDSSM
from .gru4rec import GRU4Rec
from .mind import MIND
from .narm import NARM
from .sasrec import SASRec
from .sine import SINE
from .stamp import STAMP
from .youtube_dnn import YoutubeDNN
from .youtube_sbc import YoutubeSBC

__all__ = ["DSSM", "DSSMSENet", "FaceBookDSSM", "YoutubeDNN", "YoutubeSBC", "GRU4Rec", "MIND", "ComirecSA", "ComirecDR", "SINE", "SASRec", "NARM", "STAMP"]
