from byteps_tpu_torch.server import main

if __name__ == "__main__":
    main()
