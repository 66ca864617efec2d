"""The paper's recurrent machinery: LSTM/GRU cells and the recurrent layer."""
