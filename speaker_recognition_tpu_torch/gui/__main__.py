"""`python -m speaker_recognition_tpu_torch.gui [--device cuda|cpu]`:
launch the web GUI."""

from .server import main

if __name__ == "__main__":
    main()
