from eeyore_tpu_torch.chains.chain import Chain
from eeyore_tpu_torch.chains.chain_file import ChainFile
from eeyore_tpu_torch.chains.chain_list import ChainList
from eeyore_tpu_torch.chains.chain_lists import ChainLists
from eeyore_tpu_torch.chains.checkpoint import load_state, save_state
