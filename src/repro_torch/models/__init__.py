"""Models of the port: the transformer families (``transformer.py``),
Whisper (``whisper.py``), RecurrentGemma (``griffin.py``) and xLSTM
(``xlstm.py``); ``api.build_model`` picks one by the config's family."""
