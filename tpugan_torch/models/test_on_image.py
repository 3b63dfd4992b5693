"""The zoo's one inference entry, esrgan/test_on_image.py
(``tpugan/models/test_on_image.py``):

    python -m tpugan_torch test_on_image --image_path X --checkpoint_model Y
"""

from tpugan_torch.models.esrgan import (  # noqa: F401
    TestOnImageConfig as Config,
    infer_image,
    main_test_on_image as main,
)

NAME = "test_on_image"

if __name__ == "__main__":
    main()
